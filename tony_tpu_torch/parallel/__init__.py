"""Attention over whole sequences on one device
(``ring_attention.blockwise_attention`` and ``reference_attention``) and
the mixture of experts on one card (``moe``). Ring and Ulysses sequence
parallelism and expert parallelism come with the multi-rank part of the
parallelism slice."""

from tony_tpu_torch.parallel.moe import (
    MoEConfig,
    init_moe_params,
    moe_layer,
    moe_logical_axes,
    top_k_gating,
)
from tony_tpu_torch.parallel.ring_attention import (blockwise_attention,
                                                   reference_attention)

__all__ = ["MoEConfig", "blockwise_attention", "init_moe_params",
           "moe_layer", "moe_logical_axes", "reference_attention",
           "top_k_gating"]
