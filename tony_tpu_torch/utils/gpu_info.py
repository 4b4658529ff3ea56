"""GPU device discovery — the port's counterpart of
``tony_tpu/utils/tpu_info.py``.

Reference: util/gpu/GpuDiscoverer.java:43 shells out to ``nvidia-smi``
(binary found via a configurable path + default search dirs) and gives
up after 10 consecutive failures. The port does the same with
``nvidia-smi``'s CSV queries, and never imports ``torch`` or opens a
CUDA context: the coordinator counts a host's GPUs with it, and an
agent samples the memory in use on its task's GPUs, both from processes
that have no other use for the card.

The binary is ``tony.tpu.info-exec-path`` when set (the JAX package's
key, kept so that one ``job.toml`` serves both packages; tests pass a
fake there), else ``nvidia-smi`` on the default search dirs. Queries::

    nvidia-smi --query-gpu=index,name,memory.total --format=csv,noheader
    0, NVIDIA H100 80GB HBM3, 81559 MiB

    nvidia-smi --query-gpu=index,memory.used --format=csv,noheader
    0, 1203 MiB
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
from dataclasses import dataclass, field

log = logging.getLogger(__name__)

DEFAULT_INFO_COMMAND = "nvidia-smi"
# ref: GpuDiscoverer's DEFAULT_BINARY_SEARCH_DIRS (/usr/bin,/bin,...)
DEFAULT_SEARCH_DIRS = ("/usr/bin", "/bin", "/usr/local/bin",
                       "/usr/local/nvidia/bin")
MAX_REPEATED_ERRORS = 10  # ref: GpuDiscoverer error cap
DEVICE_QUERY = ["--query-gpu=index,name,memory.total",
                "--format=csv,noheader"]
MEMORY_QUERY = ["--query-gpu=index,memory.used", "--format=csv,noheader"]
_UNITS = {"b": 1, "kib": 1024, "mib": 1024 ** 2, "gib": 1024 ** 3}


@dataclass
class PerGpuInformation:
    """Ref shape: PerGpuDeviceInformation."""

    device_id: int
    name: str = ""
    memory_total_bytes: int = 0

    def to_dict(self) -> dict:
        return {"device_id": self.device_id, "name": self.name,
                "memory_total_bytes": self.memory_total_bytes}


@dataclass
class GpuDeviceInformation:
    """Ref shape: GpuDeviceInformation. ``chips`` keeps the JAX
    package's name, which the coordinator and the provisioner read."""

    chips: list[PerGpuInformation] = field(default_factory=list)
    source: str = "none"  # nvidia-smi | none

    @property
    def chip_count(self) -> int:
        return len(self.chips)


class GpuInfoException(Exception):
    """Ref: GpuInfoException."""


def parse_bytes(text: str) -> int:
    """``'81559 MiB'`` -> bytes (a bare number is MiB, as with
    ``nounits``)."""
    parts = text.strip().split()
    if not parts:
        raise GpuInfoException("empty memory field")
    try:
        value = float(parts[0])
    except ValueError as e:
        raise GpuInfoException(f"bad memory field {text!r}") from e
    unit = parts[1].lower() if len(parts) > 1 else "mib"
    if unit not in _UNITS:
        raise GpuInfoException(f"unknown memory unit in {text!r}")
    return int(value * _UNITS[unit])


def _rows(text: str, width: int) -> list[list[str]]:
    rows = []
    for line in text.splitlines():
        if not line.strip():
            continue
        cells = [c.strip() for c in line.split(",")]
        if len(cells) != width:
            raise GpuInfoException(f"malformed nvidia-smi line {line!r}")
        rows.append(cells)
    return rows


def parse_device_csv(text: str) -> GpuDeviceInformation:
    """Parse ``DEVICE_QUERY``'s output (ref: GpuDeviceInformationParser).
    The name may not hold a comma; nvidia-smi's never do."""
    chips = []
    for idx, name, total in _rows(text, 3):
        try:
            device_id = int(idx)
        except ValueError as e:
            raise GpuInfoException(f"bad GPU index {idx!r}") from e
        chips.append(PerGpuInformation(device_id, name, parse_bytes(total)))
    return GpuDeviceInformation(chips=chips, source="nvidia-smi")


def visible_ids() -> set[int] | None:
    """The ids ``CUDA_VISIBLE_DEVICES`` names, or None when it is unset
    (every GPU) or names devices by UUID."""
    spec = os.environ.get("CUDA_VISIBLE_DEVICES")
    if spec is None:
        return None
    try:
        return {int(s) for s in spec.split(",") if s.strip()}
    except ValueError:
        return None


class GpuDiscoverer:
    """Cached, error-capped discovery (ref:
    GpuDiscoverer.getGpuDeviceInformation :88 + the consecutive-error
    cap)."""

    def __init__(self, info_exec_path: str = "",
                 search_dirs: tuple[str, ...] = DEFAULT_SEARCH_DIRS,
                 timeout_s: float = 10.0):
        self.info_exec_path = info_exec_path
        self.search_dirs = search_dirs
        self.timeout_s = timeout_s
        self.error_count = 0
        self._binary: str | None = None

    def _resolve_binary(self) -> str | None:
        if self._binary is not None:
            return self._binary or None
        if self.info_exec_path:
            self._binary = self.info_exec_path if os.path.exists(
                self.info_exec_path) else ""
        else:
            cands = [os.path.join(d, DEFAULT_INFO_COMMAND)
                     for d in self.search_dirs]
            self._binary = shutil.which(DEFAULT_INFO_COMMAND) or next(
                (c for c in cands if os.path.exists(c)), "")
        return self._binary or None

    def _query(self, args: list[str]) -> str | None:
        binary = self._resolve_binary()
        if binary is None or self.error_count >= MAX_REPEATED_ERRORS:
            return None
        try:
            out = subprocess.run(
                [binary, *args], capture_output=True, text=True,
                timeout=self.timeout_s, check=True).stdout
            self.error_count = 0
            return out
        except (subprocess.SubprocessError, OSError) as e:
            self.error_count += 1
            if self.error_count == MAX_REPEATED_ERRORS:
                log.warning("nvidia-smi failed %d times; giving up "
                            "(last: %s)", self.error_count, e)
            return None

    def get_device_information(self) -> GpuDeviceInformation:
        out = self._query(DEVICE_QUERY)
        info = GpuDeviceInformation()
        if out is not None:
            try:
                info = parse_device_csv(out)
            except GpuInfoException as e:
                self.error_count += 1
                log.warning("unreadable nvidia-smi output: %s", e)
        return info

    def device_metrics(self) -> dict[str, float]:
        """``{"memory": bytes}``: the memory in use, by every process, on
        the GPUs this process's ``CUDA_VISIBLE_DEVICES`` names (all of
        them when unset); empty when no GPU answers. The metrics
        sampler's device hook in an agent."""
        out = self._query(MEMORY_QUERY)
        if out is None:
            return {}
        ids = visible_ids()
        try:
            used = [parse_bytes(mem) for idx, mem in _rows(out, 2)
                    if ids is None or int(idx) in ids]
        except (GpuInfoException, ValueError) as e:
            log.warning("unreadable nvidia-smi output: %s", e)
            return {}
        return {"memory": float(sum(used))} if used else {}
