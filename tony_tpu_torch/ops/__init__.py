"""Kernels of the port (``decode``, ``attention``, ``adamw``), the
chunked cross-entropy (``xent``), and where they run (``platform``)."""
