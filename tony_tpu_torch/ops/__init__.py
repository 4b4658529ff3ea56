"""Kernels of the port (``decode``, ``attention``, ``adamw``, ``quant``,
``fused``), the chunked cross-entropy (``xent``), and where they run
(``platform``)."""

from tony_tpu_torch.ops.fused import add_rmsnorm, rmsnorm
from tony_tpu_torch.ops.quant import dequantize_q8, q8_matmul, quantize_q8

__all__ = ["rmsnorm", "add_rmsnorm", "quantize_q8", "dequantize_q8",
           "q8_matmul"]
