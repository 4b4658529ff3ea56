"""Data sources for the input pipeline: a copy of the framework-free
classes of ``tony_tpu/data/sources.py`` (``Source``, ``ArraySource``,
``SyntheticTokenSource``, ``PackedTokenSource``), kept here because the
port imports nothing of the JAX package.

A ``Source`` is random-access over *examples* (host-side numpy); the
``DataLoader`` (loader.py) turns it into batches of torch tensors on the
device. The device boundary is crossed exactly once, in the loader.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


class Source:
    """Random-access examples: len() + [i] -> dict of numpy arrays."""

    def __len__(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Mapping[str, np.ndarray]:
        raise NotImplementedError  # pragma: no cover - interface


class ArraySource(Source):
    """Wraps a dict of equal-leading-dim numpy arrays (in-memory dataset)."""

    def __init__(self, arrays: Mapping[str, np.ndarray]):
        if not arrays:
            raise ValueError("ArraySource needs at least one array")
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"leading dims differ: {sizes}")
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self._n = next(iter(sizes.values()))

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: int) -> Mapping[str, np.ndarray]:
        return {k: v[idx] for k, v in self.arrays.items()}


class SyntheticTokenSource(Source):
    """Deterministic random token sequences (LM training/benchmarks).

    Example i is reproducible from (seed, i) alone, so every process
    materializes identical data without coordination — the multi-host-safe
    way to synthesize.
    """

    def __init__(self, num_examples: int, seq_len: int, vocab_size: int,
                 seed: int = 0):
        self.num_examples = num_examples
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.seed = seed

    def __len__(self) -> int:
        return self.num_examples

    def __getitem__(self, idx: int) -> Mapping[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, idx))
        return {"tokens": rng.integers(
            0, self.vocab_size, (self.seq_len,), dtype=np.int32)}


class PackedTokenSource(Source):
    """Flat binary token stream (np.memmap) sliced into fixed-length
    windows — the standard packed-pretraining format (one giant .bin of
    uint16/uint32 token ids, documents separated by an EOS id upstream).

    Example i is tokens[i*stride : i*stride + seq_len + 1] split into
    ``tokens`` (inputs) and ``labels`` (inputs shifted by one), so the
    loader feeds next-token prediction directly. ``stride`` defaults to
    ``seq_len`` (disjoint windows); smaller strides overlap.

    memmap keeps the host working set at pages actually touched, so a
    multi-hundred-GB corpus serves random access from every host without
    loading; combined with the DataLoader's per-process strides each host
    only ever pages in its own shard of the permutation.
    """

    def __init__(self, path: str, seq_len: int, dtype=np.uint16,
                 stride: int | None = None,
                 segment_eos_id: int | None = None):
        self.path = str(path)
        self.seq_len = seq_len
        self.stride = seq_len if stride is None else stride
        # emit per-window "segments" (document index within the window,
        # split at this eos id) for segment-masked attention — packed
        # documents then never attend across their boundaries
        self.segment_eos_id = segment_eos_id
        if self.stride <= 0:
            raise ValueError(f"stride must be positive, got {self.stride}")
        self._tokens = np.memmap(self.path, dtype=dtype, mode="r")
        # +1: each window needs a trailing target for the shifted labels
        n = (len(self._tokens) - self.seq_len - 1) // self.stride + 1
        if len(self._tokens) < self.seq_len + 1:
            raise ValueError(
                f"{path}: {len(self._tokens)} tokens < seq_len+1 "
                f"({self.seq_len + 1})")
        self._n = n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: int) -> Mapping[str, np.ndarray]:
        start = idx * self.stride
        window = np.asarray(self._tokens[start:start + self.seq_len + 1],
                            dtype=np.int32)
        out = {"tokens": window[:-1], "labels": window[1:]}
        if self.segment_eos_id is not None:
            toks = out["tokens"]
            is_eos = (toks == self.segment_eos_id).astype(np.int32)
            # segment of position i = number of eos strictly before i
            # (an eos token still belongs to the document it terminates)
            out["segments"] = np.cumsum(is_eos) - is_eos
        return out
