"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers,
so one file compiles in seconds) and becomes ``build/kernels/
lib<name>-<hash>.so``; the hash of the source names the library, so an
edited source never loads a stale build. ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

from tony_tpu_torch.ops.platform import BUILD_DIR, CSRC_DIR

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas resource lines (registers, shared memory, spills) per source
ptxas_report: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start(name: str):
    src, lib = _target(name)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, lib = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{out}")
    ptxas_report[name] = "\n".join(
        ln for ln in out.splitlines() if "ptxas" in ln or "spill" in ln)
    os.replace(tmp, lib)


def sources() -> list[str]:
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def build_all() -> None:
    """Compile every stale source in parallel (one ``nvcc`` each)."""
    with _lock:
        started = {n: _start(n) for n in sources()}
        for n, st in started.items():
            _finish(n, st)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(_target(name)[1])
            _libs[name] = lib
        return lib
