"""Raw text -> packed token corpus (the ``PackedTokenSource`` input
format): a copy of ``tony_tpu/data/tokenize.py``, kept here because the
port imports nothing of the JAX package. Numpy only; the bytes written
are the JAX module's.

Stream documents through any tokenizer, append an EOS separator per
document, and write one flat binary of token ids that
``PackedTokenSource`` memmaps. ``encode`` is any ``str -> sequence[int]``
callable, so a fast tokenizer's ``encode``, sentencepiece, or the
in-tree ``ByteTokenizer`` all plug in without this module importing any
of them.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Sequence

import numpy as np


class ByteTokenizer:
    """Zero-dependency fallback tokenizer: UTF-8 bytes as token ids.

    vocab: 256 byte values + 1 EOS (id 256) -> vocab_size 257. Lossless
    round-trip for any text; the standard baseline when no trained
    tokenizer is at hand (and what makes examples/tests runnable offline).
    """

    vocab_size = 257
    eos_id = 256

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode(
            "utf-8", errors="replace")


class _BinWriter:
    """Buffered token-id sink with dtype range checking per flush."""

    def __init__(self, f, dtype, buffer_tokens: int):
        self.f = f
        self.dtype = np.dtype(dtype)
        self.limit = np.iinfo(self.dtype).max
        self.buffer_tokens = buffer_tokens
        self.buf: list[int] = []
        self.total = 0

    def append(self, ids: Iterable[int]) -> None:
        self.buf.extend(int(i) for i in ids)
        if len(self.buf) >= self.buffer_tokens:
            self.flush()

    def flush(self) -> None:
        if not self.buf:
            return
        arr = np.asarray(self.buf, dtype=np.int64)
        if arr.min() < 0 or arr.max() > self.limit:
            raise ValueError(
                f"token id out of range for {self.dtype} "
                f"(min {arr.min()}, max {arr.max()}, limit {self.limit})")
        arr.astype(self.dtype).tofile(self.f)
        self.total += len(self.buf)
        self.buf.clear()


def encode_corpus_to_bin(
    texts: Iterable[str],
    out_path: str,
    encode: Callable[[str], Sequence[int]],
    *,
    eos_id: int | None = None,
    dtype=np.uint16,
    buffer_tokens: int = 1 << 20,
) -> int:
    """Stream ``texts`` through ``encode`` into a flat token .bin.

    Each document's ids are appended, followed by ``eos_id`` (when given)
    as the document separator — the packed format PackedTokenSource
    expects. Writing is buffered (``buffer_tokens`` ids per flush) so a
    corpus never has to fit in memory. Returns the total token count.

    dtype must hold every id (uint16 for vocab < 65536; uint32 above) —
    overflow is checked per flush, not silently wrapped.
    """
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        w = _BinWriter(f, dtype, buffer_tokens)
        for text in texts:
            w.append(encode(text))
            if eos_id is not None:
                w.append([eos_id])
        w.flush()
    return w.total


def encode_files_to_bin(paths: Sequence[str], out_path: str,
                        encode: Callable[[str], Sequence[int]], *,
                        eos_id: int | None = None, dtype=np.uint16,
                        block_bytes: int | None = None) -> int:
    """Stream files into one packed .bin, EOS separator once per FILE.

    By default each file is encoded in ONE ``encode`` call — lossless for
    every tokenizer (BPE merges and per-call special tokens see the whole
    document), at the cost of holding one file's text + ids in memory.

    ``block_bytes`` opts into streaming for files too large for that:
    ~block_bytes chunks split at LINE boundaries. Only use it with a
    split-invariant ``encode`` (bytes/chars, or a subword tokenizer called
    with special tokens off AND whose merges never span a newline) —
    otherwise every block boundary perturbs the token stream.
    """
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        w = _BinWriter(f, dtype, 1 << 20)
        for path in paths:
            with open(path, encoding="utf-8") as src:
                if block_bytes is None:
                    w.append(encode(src.read()))
                else:
                    block: list[str] = []
                    size = 0
                    for line in src:
                        block.append(line)
                        size += len(line)
                        if size >= block_bytes:
                            w.append(encode("".join(block)))
                            block, size = [], 0
                    if block:
                        w.append(encode("".join(block)))
            if eos_id is not None:
                w.append([eos_id])
        w.flush()
    return w.total
