"""Parallelism: the named device mesh (``mesh``), the sharding presets and
spec math with the local-shard functions (``sharding``), named-axis
collectives over the mesh's process groups (``collectives``), attention
over whole sequences on one device (``ring_attention``) and the mixture
of experts on one card (``moe``). Ring and Ulysses sequence parallelism,
pipelining and expert parallelism are still to port (ROADMAP.md
section 1, item 5)."""

from tony_tpu_torch.parallel.mesh import (
    ALL_AXES,
    DATA,
    EXPERT,
    FSDP,
    PIPE,
    SEQ,
    TENSOR,
    Mesh,
    MeshSpec,
    data_parallel_mesh,
    make_mesh,
    multislice_mesh,
    num_slices,
)
from tony_tpu_torch.parallel.moe import (
    MoEConfig,
    init_moe_params,
    moe_layer,
    moe_logical_axes,
    top_k_gating,
)
from tony_tpu_torch.parallel.ring_attention import (blockwise_attention,
                                                   reference_attention)
from tony_tpu_torch.parallel.sharding import (
    RULES,
    NamedSharding,
    PartitionSpec,
    batch_sharding,
    replicated,
    shard_params_by_size,
    spec_for,
    tree_shardings,
)

__all__ = [
    "ALL_AXES", "DATA", "EXPERT", "FSDP", "PIPE", "SEQ", "TENSOR",
    "Mesh", "MeshSpec", "MoEConfig", "NamedSharding", "PartitionSpec",
    "RULES", "batch_sharding", "blockwise_attention", "data_parallel_mesh",
    "init_moe_params", "make_mesh", "moe_layer", "moe_logical_axes",
    "multislice_mesh", "num_slices", "reference_attention", "replicated",
    "shard_params_by_size", "spec_for", "top_k_gating", "tree_shardings",
]
