"""The port's ``DataLoader`` and sources against the JAX package's
(``sharding=None``, which yields host numpy): the same batches in the
same order for the same (seed, epoch), process strides, remainder
policy, epoch count and ``from_step``; the copied sources give the same
examples. Exact equality throughout."""

import threading
import time

import numpy as np
import pytest
import torch

from tony_tpu.data import ArraySource as JaxArraySource
from tony_tpu.data import DataLoader as JaxDataLoader
from tony_tpu.data import PackedTokenSource as JaxPacked
from tony_tpu.data import SyntheticTokenSource as JaxSynthetic
from tony_tpu_torch.data import (ArraySource, DataLoader, PackedTokenSource,
                                 SyntheticTokenSource)


def _arrays(n=37):
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((n, 3)).astype(np.float32),
            "tokens": rng.integers(0, 100, (n, 5)).astype(np.int32)}


def _same(jl, tl):
    jb, tb = list(jl), list(tl)
    assert len(jb) == len(tb) > 0
    for j, t in zip(jb, tb):
        assert set(j) == set(t)
        for k in j:
            assert t[k].device.type == "cpu"
            np.testing.assert_array_equal(t[k].numpy(), j[k])


@pytest.mark.parametrize("kw", [
    dict(),
    dict(shuffle=False),
    dict(drop_remainder=False),
    dict(process_index=1, process_count=3),
    dict(process_index=2, process_count=3, drop_remainder=False),
    dict(seed=7, prefetch=0),
])
def test_loader_yields_the_jax_loaders_batches(kw):
    kw = {"process_index": 0, "process_count": 1, **kw}
    a = _arrays()
    common = dict(global_batch_size=6 if kw["process_count"] == 3 else 4,
                  num_epochs=3, **kw)
    _same(JaxDataLoader(JaxArraySource(a), **common),
          DataLoader(ArraySource(a), device="cpu", **common))


@pytest.mark.parametrize("step", [0, 3, 9, 20])
def test_from_step_matches_the_jax_loader(step):
    a = _arrays()
    common = dict(global_batch_size=4, num_epochs=3, process_index=0,
                  process_count=1)
    _same(JaxDataLoader(JaxArraySource(a), **common).from_step(step),
          DataLoader(ArraySource(a), device="cpu", **common).from_step(step))


def test_copied_sources_give_the_same_examples(tmp_path):
    js, ts = JaxSynthetic(5, 8, 50, seed=3), SyntheticTokenSource(5, 8, 50,
                                                                  seed=3)
    assert len(js) == len(ts)
    for i in range(5):
        np.testing.assert_array_equal(js[i]["tokens"], ts[i]["tokens"])
    path = tmp_path / "corpus.bin"
    np.random.default_rng(0).integers(0, 9, 200).astype(np.uint16).tofile(
        path)
    jp = JaxPacked(str(path), seq_len=16, stride=12, segment_eos_id=0)
    tp = PackedTokenSource(str(path), seq_len=16, stride=12,
                           segment_eos_id=0)
    assert len(jp) == len(tp)
    for i in range(len(tp)):
        for k in ("tokens", "labels", "segments"):
            np.testing.assert_array_equal(jp[i][k], tp[i][k])


def test_loader_checks_like_the_jax_loader():
    a = _arrays(5)
    with pytest.raises(ValueError, match="too small"):
        DataLoader(ArraySource(a), 8, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        DataLoader(ArraySource(a), 3, process_count=2, process_index=0,
                   device="cpu")
    with pytest.raises(ValueError, match="drop_remainder"):
        DataLoader(ArraySource(a), 2, drop_remainder=False,
                   device="cpu").from_step(1)


def test_loader_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataLoader(ArraySource(_arrays()), 4)


def test_closing_the_iterator_stops_the_prefetch_thread():
    before = threading.active_count()
    it = DataLoader(ArraySource(_arrays()), 4, num_epochs=None,
                    device="cpu").from_step(0)
    next(it)
    it.close()
    for _ in range(100):
        if threading.active_count() <= before:
            break
        time.sleep(0.02)
    assert threading.active_count() <= before


def test_prefetch_surfaces_source_errors():
    class Broken(ArraySource):
        def __getitem__(self, idx):
            if idx == 3:
                raise KeyError("bad example")
            return super().__getitem__(idx)

    loader = DataLoader(Broken(_arrays()), 4, shuffle=False, device="cpu")
    with pytest.raises(KeyError, match="bad example"):
        list(loader)
