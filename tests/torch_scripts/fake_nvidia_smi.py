#!/usr/bin/env python3
"""A stand-in for ``nvidia-smi``'s two CSV queries, over the GPUs that
``FAKE_GPUS`` counts (default 1): an H100's name and memory, and
``FAKE_GPU_USED_MIB`` (default 1024) in use on each."""

import os
import sys

n = int(os.environ.get("FAKE_GPUS", "1"))
used = int(os.environ.get("FAKE_GPU_USED_MIB", "1024"))
query = next((a for a in sys.argv[1:] if a.startswith("--query-gpu=")), "")
for i in range(n):
    if query == "--query-gpu=index,name,memory.total":
        print(f"{i}, NVIDIA H100 80GB HBM3, 81559 MiB")
    elif query == "--query-gpu=index,memory.used":
        print(f"{i}, {used} MiB")
    else:
        sys.exit(f"unsupported query {sys.argv[1:]}")
