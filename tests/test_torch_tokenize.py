"""The port's copy of ``tony_tpu/data/tokenize.py`` against the JAX
package's: ``ByteTokenizer`` encodes and decodes alike (and round-trips
any text), and the packed-corpus writers write byte-equal ``.bin`` files
with equal token counts (EOS separators, several flushes, the line-block
streaming path, uint16 and uint32), and refuse the same overflow."""

import numpy as np
import pytest

from tony_tpu.data import tokenize as jax_tok
from tony_tpu_torch.data import (ByteTokenizer, encode_corpus_to_bin,
                                 encode_files_to_bin)

TEXTS = ["hello world", "", "ünïcødé — 漢字 🙂", "line one\nline two\n",
         "x" * 300]


def test_byte_tokenizer_matches_and_round_trips():
    tok, ref = ByteTokenizer(), jax_tok.ByteTokenizer()
    assert (tok.vocab_size, tok.eos_id) == (ref.vocab_size, ref.eos_id) \
        == (257, 256)
    for text in TEXTS:
        ids = tok.encode(text)
        assert ids == ref.encode(text)
        assert tok.decode(ids) == text
        assert tok.decode(ids + [tok.eos_id]) == ref.decode(
            ids + [ref.eos_id]) == text
    # a cut multi-byte sequence decodes with replacement, alike
    cut = tok.encode("漢字")[:4]
    assert tok.decode(cut) == ref.decode(cut)


@pytest.mark.parametrize("eos,dtype,buffer_tokens", [
    (256, np.uint16, 7), (None, np.uint16, 1 << 20), (70000, np.uint32, 5)])
def test_corpus_writer_is_byte_equal(tmp_path, eos, dtype, buffer_tokens):
    tok = ByteTokenizer()
    kw = dict(eos_id=eos, dtype=dtype, buffer_tokens=buffer_tokens)
    n = encode_corpus_to_bin(iter(TEXTS), str(tmp_path / "port.bin"),
                             tok.encode, **kw)
    m = jax_tok.encode_corpus_to_bin(iter(TEXTS), str(tmp_path / "jax.bin"),
                                     tok.encode, **kw)
    assert n == m > 0
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()
    assert len((tmp_path / "port.bin").read_bytes()) == \
        n * np.dtype(dtype).itemsize


@pytest.mark.parametrize("block_bytes", [None, 8])
def test_files_writer_is_byte_equal(tmp_path, block_bytes):
    paths = []
    for i, text in enumerate(TEXTS):
        p = tmp_path / f"doc{i}.txt"
        p.write_text(text, encoding="utf-8")
        paths.append(str(p))
    enc = ByteTokenizer().encode
    kw = dict(eos_id=256, block_bytes=block_bytes)
    n = encode_files_to_bin(paths, str(tmp_path / "out" / "port.bin"), enc,
                            **kw)
    m = jax_tok.encode_files_to_bin(paths, str(tmp_path / "out" / "jax.bin"),
                                    enc, **kw)
    assert n == m
    assert (tmp_path / "out" / "port.bin").read_bytes() == \
        (tmp_path / "out" / "jax.bin").read_bytes()


def test_overflow_is_refused_alike(tmp_path):
    for fn in (encode_corpus_to_bin, jax_tok.encode_corpus_to_bin):
        with pytest.raises(ValueError, match="out of range for uint16"):
            fn(["a"], str(tmp_path / "x.bin"), lambda t: [70000])
