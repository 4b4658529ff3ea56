"""Input pipeline: numpy sources (``sources``) and the prefetching loader
that lands batches on the device (``loader``)."""

from tony_tpu_torch.data.loader import DataLoader
from tony_tpu_torch.data.sources import (ArraySource, PackedTokenSource,
                                         Source, SyntheticTokenSource)

__all__ = ["ArraySource", "DataLoader", "PackedTokenSource", "Source",
           "SyntheticTokenSource"]
