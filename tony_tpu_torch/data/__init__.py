"""Input pipeline: numpy sources (``sources``), the byte tokenizer and
packed-corpus writers (``tokenize``), and the prefetching loader that
lands batches on the device (``loader``)."""

from tony_tpu_torch.data.loader import DataLoader, device_prefetch
from tony_tpu_torch.data.sources import (ArraySource, InstructionSource,
                                         JsonlSource, MixtureSource,
                                         PackedTokenSource, Source,
                                         SyntheticImageSource,
                                         SyntheticTokenSource)
from tony_tpu_torch.data.tokenize import (ByteTokenizer,
                                          encode_corpus_to_bin,
                                          encode_files_to_bin)

__all__ = ["ArraySource", "ByteTokenizer", "DataLoader",
           "InstructionSource", "JsonlSource", "MixtureSource",
           "PackedTokenSource", "Source", "SyntheticImageSource",
           "SyntheticTokenSource", "device_prefetch", "encode_corpus_to_bin",
           "encode_files_to_bin"]
