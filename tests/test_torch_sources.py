"""The sources the port copies from ``tony_tpu/data/sources.py``
(``SyntheticImageSource``, ``JsonlSource``, ``InstructionSource``,
``MixtureSource``) against the JAX package's: for the same seed and
index every example is bit-equal, key by key and dtype by dtype,
``MixtureSource.component_counts`` included, and both refuse the same
arguments. Through the port's ``DataLoader`` on the CPU they give the
JAX loader's batches. ``device_prefetch`` on the CPU yields the batches
of the synchronous loader, keeps the structure of nested batches,
passes tensors through, propagates the producer's error and stops its
thread when closed early."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from tony_tpu.data import ArraySource as JaxArraySource
from tony_tpu.data import DataLoader as JaxDataLoader
from tony_tpu.data import sources as jax_sources
from tony_tpu_torch.data import (ArraySource, ByteTokenizer, DataLoader,
                                 InstructionSource, JsonlSource,
                                 MixtureSource, SyntheticImageSource,
                                 SyntheticTokenSource, device_prefetch)

ROWS = [{"prompt": "2+2=", "completion": "4"},
        {"prompt": "unicode ✓ prompt", "completion": "done"},
        {"prompt": "p" * 20, "completion": "overlong"},
        {"prompt": "", "completion": "only a completion"},
        {"prompt": "q", "completion": "", "extra": [1, 2, 3]}]


def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _jsonl(tmp_path, name, rows, blank=False):
    p = tmp_path / name
    lines = [json.dumps(r) for r in rows]
    if blank:
        lines.insert(1, "")
    p.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(p)


@pytest.mark.parametrize("shape", [(8, 8, 3), (5, 7, 1)])
def test_synthetic_images_are_bit_equal(shape):
    h, w, c = shape
    ours = SyntheticImageSource(6, h, w, c, num_classes=13, seed=4)
    ref = jax_sources.SyntheticImageSource(6, h, w, c, num_classes=13,
                                           seed=4)
    assert len(ours) == len(ref) == 6
    for i in range(6):
        _same(ours[i], ref[i])
    assert ours[0]["image"].dtype == np.float32


def test_jsonl_source_is_bit_equal(tmp_path):
    tok_rows = [{"tokens": [1, 2, 3], "w": 0.5}, {"tokens": [4, 5, 6],
                                                   "w": 1.5}]
    paths = [_jsonl(tmp_path, "a.jsonl", ROWS, blank=True),
             _jsonl(tmp_path, "b.jsonl", ROWS[:2])]
    ours, ref = JsonlSource(paths), jax_sources.JsonlSource(paths)
    assert len(ours) == len(ref) == len(ROWS) + 2
    for i in range(len(ours)):
        _same(ours[i], ref[i])
    one = _jsonl(tmp_path, "t.jsonl", tok_rows)
    kw = dict(dtypes={"tokens": np.int32, "w": np.float32})
    ours, ref = JsonlSource(one, **kw), jax_sources.JsonlSource(one, **kw)
    for i in range(2):
        _same(ours[i], ref[i])


@pytest.mark.parametrize("kw", [
    dict(seq_len=8, eos_id=256),
    dict(seq_len=6),
    dict(seq_len=32, eos_id=0, pad_id=7),
    dict(seq_len=12, eos_id=256, prompt_key="completion",
         completion_key="prompt")], ids=["eos", "short", "pad", "keys"])
def test_instruction_source_is_bit_equal(tmp_path, kw):
    path = _jsonl(tmp_path, "sft.jsonl", ROWS)
    tok = ByteTokenizer()
    ours = InstructionSource(JsonlSource(path), tok, **kw)
    ref = jax_sources.InstructionSource(jax_sources.JsonlSource(path), tok,
                                        **kw)
    for i in range(len(ROWS)):
        _same(ours[i], ref[i])
    listed = InstructionSource(ROWS, tok, **kw)  # any sequence of dicts
    _same(listed[1], ref[1])
    for cls in (InstructionSource, jax_sources.InstructionSource):
        with pytest.raises(ValueError, match="seq_len must be >= 2"):
            cls(ROWS, tok, seq_len=1)


def test_mixture_source_is_bit_equal():
    a = {"x": np.arange(20, dtype=np.float32).reshape(10, 2)}
    b = {"x": -np.arange(6, dtype=np.float32).reshape(3, 2)}
    c = {"x": np.full((5, 2), 9.0, np.float32)}
    parts = [(a, 0.5), (b, 0.2), (c, 0.3)]
    ours = MixtureSource([(ArraySource(s), w) for s, w in parts],
                         num_examples=500, seed=7)
    ref = jax_sources.MixtureSource(
        [(JaxArraySource(s), w) for s, w in parts], num_examples=500, seed=7)
    np.testing.assert_array_equal(ours.component_counts(),
                                  ref.component_counts())
    assert ours.component_counts().sum() == len(ours) == 500
    for i in range(500):
        _same(ours[i], ref[i])
    for cls, src in ((MixtureSource, ArraySource(a)),
                     (jax_sources.MixtureSource, JaxArraySource(a))):
        with pytest.raises(ValueError, match="positive"):
            cls([(src, 0.0)], num_examples=10)
        with pytest.raises(ValueError, match="at least one"):
            cls([], num_examples=10)


def test_new_sources_through_the_loader_match_the_jax_loader(tmp_path):
    path = _jsonl(tmp_path, "sft.jsonl", ROWS * 3)
    tok = ByteTokenizer()
    common = dict(global_batch_size=4, num_epochs=2, seed=3,
                  process_index=0, process_count=1)
    pairs = (
        (InstructionSource(JsonlSource(path), tok, seq_len=10, eos_id=256),
         jax_sources.InstructionSource(jax_sources.JsonlSource(path), tok,
                                       seq_len=10, eos_id=256)),
        (SyntheticImageSource(12, 4, 4, num_classes=5, seed=2),
         jax_sources.SyntheticImageSource(12, 4, 4, num_classes=5, seed=2)))
    for ours, ref in pairs:
        got = list(DataLoader(ours, device="cpu", **common))
        want = list(JaxDataLoader(ref, **common))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _same({k: v.numpy() for k, v in g.items()}, w)


def _host_loader(prefetch):
    return DataLoader(SyntheticTokenSource(24, 6, 50, seed=1), 4,
                      num_epochs=2, device="cpu", prefetch=prefetch)


def test_device_prefetch_yields_the_synchronous_batches():
    want = list(_host_loader(0))
    got = list(device_prefetch(_host_loader(2), device="cpu", size=3))
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g["tokens"].device.type == "cpu"
        assert torch.equal(g["tokens"], w["tokens"])
    host = [{"x": np.full((2, 3), i, np.float32),
             "pair": (np.arange(i + 1), [torch.ones(2) * i])}
            for i in range(3)]
    out = list(device_prefetch(iter(host), device="cpu"))
    for i, b in enumerate(out):
        assert isinstance(b["pair"], tuple) and isinstance(b["pair"][1],
                                                           list)
        assert torch.equal(b["x"], torch.full((2, 3), float(i)))
        assert torch.equal(b["pair"][0], torch.arange(i + 1))
        assert b["pair"][1][0] is host[i]["pair"][1][0]  # passed through


def test_device_prefetch_propagates_errors_and_stops_when_closed():
    def bad():
        yield {"x": np.zeros(2)}
        raise RuntimeError("boom")

    it = device_prefetch(bad(), device="cpu")
    assert next(it)["x"].shape == (2,)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)

    before = threading.active_count()

    def endless():
        i = 0
        while True:
            yield {"x": np.full(1, i)}
            i += 1

    it = device_prefetch(endless(), device="cpu", size=2)
    assert int(next(it)["x"][0]) == 0
    it.close()
    deadline = time.monotonic() + 30
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_device_prefetch_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_prefetch(iter([]))
