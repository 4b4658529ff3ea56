"""PyTorch/CUDA port of tony-tpu's serving and training paths for NVIDIA
Hopper.

The JAX package ``tony_tpu`` is the reference; this package mirrors its
module paths and public names (``tony_tpu_torch.models.transformer`` is
the counterpart of ``tony_tpu.models.transformer``, and so on) and
imports nothing of it. Plain tensor code is PyTorch; the Pallas kernels
on those paths (flash-decode; flash attention forward, dQ and dK/dV;
fused AdamW) are CUDA C++ kernels for ``sm_90a`` under ``csrc/``, built
with ``nvcc`` at first use.

Entry points (``Server``, ``generate``, the CLI, ``Transformer``,
``DataLoader``) run on ``cuda`` unless the caller passes
``device="cpu"``; with no CUDA device and no explicit CPU request they
raise.
"""
