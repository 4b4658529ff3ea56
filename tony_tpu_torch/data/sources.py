"""Data sources for the input pipeline: a copy of the framework-free
classes of ``tony_tpu/data/sources.py`` (``Source``, ``ArraySource``,
``SyntheticTokenSource``, ``SyntheticImageSource``, ``JsonlSource``,
``InstructionSource``, ``PackedTokenSource``, ``MixtureSource``), kept
here because the port imports nothing of the JAX package. For the same
seed and index each yields the JAX source's arrays, bit for bit.

A ``Source`` is random-access over *examples* (host-side numpy); the
``DataLoader`` (loader.py) turns it into batches of torch tensors on the
device. The device boundary is crossed exactly once, in the loader.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping, Sequence

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


class SyntheticImageSource(Source):
    """Deterministic random image/label pairs (vision benchmarks)."""

    def __init__(self, num_examples: int, height: int, width: int,
                 channels: int = 3, num_classes: int = 1000, seed: int = 0):
        self.num_examples = num_examples
        self.shape = (height, width, channels)
        self.num_classes = num_classes
        self.seed = seed

    def __len__(self) -> int:
        return self.num_examples

    def __getitem__(self, idx: int) -> Mapping[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, idx))
        return {
            "image": rng.standard_normal(self.shape, dtype=np.float32),
            "label": np.int32(rng.integers(0, self.num_classes)),
        }


class JsonlSource(Source):
    """Pre-tokenized examples from .jsonl file(s): one JSON object per line,
    values are lists/scalars converted to numpy. Line offsets are indexed
    once at open, so access is random without loading the file into memory.
    """

    def __init__(self, paths: str | Sequence[str],
                 dtypes: Mapping[str, Any] | None = None):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        self.paths = [str(p) for p in paths]
        self.dtypes = dict(dtypes or {})
        self._index: list[tuple[int, int]] = []  # (file idx, byte offset)
        for fi, path in enumerate(self.paths):
            offset = 0
            with open(path, "rb") as f:
                for line in f:
                    if line.strip():
                        self._index.append((fi, offset))
                    offset += len(line)

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, idx: int) -> Mapping[str, np.ndarray]:
        fi, offset = self._index[idx]
        with open(self.paths[fi], "rb") as f:
            f.seek(offset)
            obj = json.loads(f.readline())
        out = {}
        for k, v in obj.items():
            dtype = self.dtypes.get(k)
            out[k] = np.asarray(v, dtype=dtype) if dtype else np.asarray(v)
        return out


class InstructionSource(Source):
    """Supervised fine-tuning examples: prompt/completion pairs ->
    fixed-length ``{"tokens", "loss_mask"}`` where the mask is 1 ONLY on
    completion (+eos) token positions — prompts and padding contribute
    nothing to the objective. The standard SFT recipe wired to the
    in-tree loss::

        loss = cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:],
                                  mask=batch["loss_mask"][:, 1:])

    (``loss_mask[t]`` marks token t as a PREDICTION TARGET; shifting by
    one aligns it with the teacher-forced logits, exactly like the
    packed-corpus segment masking.)

    ``pairs`` is any Source/sequence of dicts carrying text under
    ``prompt_key``/``completion_key`` (e.g. a ``JsonlSource`` over an
    instruction dataset). ``tokenizer`` is any object with ``encode()``
    (the in-tree ``ByteTokenizer`` works fully offline). Tokenization is
    lazy per example — nothing is materialized up front. Examples whose
    prompt alone fills ``seq_len`` yield an all-zero mask (0 loss), not
    an error: bulk datasets carry a tail of overlong rows.
    """

    def __init__(self, pairs, tokenizer, seq_len: int, *,
                 prompt_key: str = "prompt",
                 completion_key: str = "completion",
                 eos_id: int | None = None, pad_id: int = 0):
        if seq_len < 2:
            raise ValueError("seq_len must be >= 2 (one target at least)")
        self.pairs = pairs
        self.tokenizer = tokenizer
        self.seq_len = seq_len
        self.prompt_key = prompt_key
        self.completion_key = completion_key
        self.eos_id = eos_id
        self.pad_id = pad_id

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int) -> Mapping[str, np.ndarray]:
        row = self.pairs[idx]
        prompt = self.tokenizer.encode(str(row[self.prompt_key]))
        completion = self.tokenizer.encode(str(row[self.completion_key]))
        if self.eos_id is not None:
            completion = completion + [self.eos_id]
        tokens = np.full((self.seq_len,), self.pad_id, np.int32)
        mask = np.zeros((self.seq_len,), np.float32)
        ids = (prompt + completion)[:self.seq_len]
        tokens[:len(ids)] = ids
        mask[len(prompt):len(ids)] = 1.0  # completion positions only
        return {"tokens": tokens, "loss_mask": mask}


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


class MixtureSource(Source):
    """Weighted mixture of sources — the standard pretraining-corpus blend
    (e.g. 70% web, 20% code, 10% books).

    Deterministic and multi-host safe: example i's component is drawn from
    (seed, i) alone and its index within the component advances as an
    independent deterministic stream, so every process materializes the
    identical mixture without coordination (same contract as
    SyntheticTokenSource). Components cycle independently: a small
    component repeats (standard epoch-mixing) rather than truncating the
    mixture. All components must share an example schema.

    ``num_examples`` bounds the virtual length (mixtures are usually
    sampled-with-replacement streams, so length is a budget, not a size).
    """

    def __init__(self, components: "Sequence[tuple[Source, float]]",
                 num_examples: int, seed: int = 0):
        if not components:
            raise ValueError("MixtureSource needs at least one component")
        self.sources = [s for s, _ in components]
        weights = np.asarray([w for _, w in components], np.float64)
        if (weights <= 0).any():
            raise ValueError(f"weights must be positive, got {weights}")
        self.probs = weights / weights.sum()
        self.num_examples = num_examples
        self.seed = seed
        # per-component pick counts are cumulative over the index stream;
        # computing them per __getitem__ would be O(i), so precompute the
        # component choice for every index once (num_examples ints)
        rng = np.random.default_rng((seed, 0xB1E2D))
        self._choice = rng.choice(len(self.sources), size=num_examples,
                                  p=self.probs).astype(np.int32)
        # within-component position: the k-th pick of component c maps to
        # its example (k mod len(c)); vectorized — a Python loop here
        # would cost minutes of per-host startup at stream-scale budgets
        self._pos = np.zeros(num_examples, np.int64)
        for c in range(len(self.sources)):
            mask = self._choice == c
            self._pos[mask] = np.arange(int(mask.sum()), dtype=np.int64)

    def __len__(self) -> int:
        return self.num_examples

    def __getitem__(self, idx: int) -> Mapping[str, np.ndarray]:
        c = int(self._choice[idx])
        src = self.sources[c]
        return src[int(self._pos[idx]) % len(src)]

    def component_counts(self) -> np.ndarray:
        """How many of the virtual examples come from each component."""
        return np.bincount(self._choice, minlength=len(self.sources))
