"""Per-task resource metrics sampler.

Reference: TaskMonitor.java:25 — a scheduled thread sampling RSS (via
ResourceCalculatorProcessTree) and GPU util/memory (via nvidia-smi XML,
util/gpu/GpuDiscoverer.java), keeping max + running-average aggregates,
pushed to the coordinator's metrics RPC. The port samples the user
process tree's RSS from /proc and the memory in use on the card, by
every process (absent without CUDA): through ``torch`` by default (a
process that already holds a CUDA context, as the in-process gateway
does), or through a ``device_fn`` the caller gives, as the task agent
gives ``utils.gpu_info``'s ``nvidia-smi`` query, which opens no context.
"""

from __future__ import annotations

import logging
import os
import threading

log = logging.getLogger(__name__)

# Metric names (ref: TaskMonitor.METRICS_TO_COLLECT :34-37)
MAX_MEMORY_RSS = "MAX_MEMORY_RSS"
AVG_MEMORY_RSS = "AVG_MEMORY_RSS"
MAX_GPU_MEMORY = "MAX_GPU_MEMORY"
AVG_GPU_MEMORY = "AVG_GPU_MEMORY"


def device_metrics() -> dict:
    """``{"memory": bytes}``: the memory in use on the card, by every
    process (the sampled process is another one); empty without
    CUDA."""
    import torch

    if not torch.cuda.is_available():
        return {}
    free, total = torch.cuda.mem_get_info()
    return {"memory": float(total - free)}


def process_tree_rss_bytes(pid: int) -> int:
    """Sum VmRSS over ``pid`` and its descendants (ResourceCalculator
    equivalent). Returns 0 when the tree is gone."""
    total = 0
    for p in _descendants(pid) | {pid}:
        try:
            with open(f"/proc/{p}/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        total += int(line.split()[1]) * 1024
                        break
        except (FileNotFoundError, ProcessLookupError, PermissionError):
            continue
    return total


def _descendants(pid: int) -> set[int]:
    children: dict[int, list[int]] = {}
    try:
        for entry in os.listdir("/proc"):
            if not entry.isdigit():
                continue
            try:
                with open(f"/proc/{entry}/stat") as f:
                    parts = f.read().split()
                ppid = int(parts[3])
                children.setdefault(ppid, []).append(int(entry))
            except (OSError, IndexError, ValueError):
                continue
    except OSError:
        return set()
    out: set[int] = set()
    stack = [pid]
    while stack:
        p = stack.pop()
        for c in children.get(p, []):
            if c not in out:
                out.add(c)
                stack.append(c)
    return out


class TaskMetricsMonitor:
    """Sampler thread with max/avg aggregation (ref: setAvgMetrics/
    setMaxMetrics TaskMonitor.java:172-186)."""

    def __init__(self, pid_fn, push_fn, interval_ms: int = 5000,
                 device_fn=None):
        self.pid_fn = pid_fn  # () -> pid | None of the user process
        self.push_fn = push_fn  # (metrics: dict) -> None
        # () -> {"memory": bytes} | {}
        self.device_fn = device_fn or device_metrics
        self.interval_s = max(interval_ms, 100) / 1000
        self._samples = 0
        self.metrics: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def sample_once(self) -> dict[str, float]:
        pid = self.pid_fn()
        if pid is None:
            return self.metrics
        rss = float(process_tree_rss_bytes(pid))
        self._samples += 1
        self._fold(MAX_MEMORY_RSS, AVG_MEMORY_RSS, rss)
        dev = self.device_fn()
        if "memory" in dev:
            self._fold(MAX_GPU_MEMORY, AVG_GPU_MEMORY, dev["memory"])
        return self.metrics

    def _fold(self, max_key: str, avg_key: str, value: float) -> None:
        self.metrics[max_key] = max(self.metrics.get(max_key, 0.0), value)
        prev = self.metrics.get(avg_key, 0.0)
        self.metrics[avg_key] = prev + (value - prev) / self._samples

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.push_fn(self.sample_once())
            except Exception:
                log.exception("metrics push failed")

    def start(self) -> "TaskMetricsMonitor":
        self._thread = threading.Thread(target=self._loop, name="task-metrics",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


class MetricsStore:
    """Coordinator-side metrics sink (ref: rpc/impl/MetricsRpcServer.java)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_task: dict[str, dict[str, float]] = {}

    def update_metrics(self, task_id: str, metrics: dict) -> bool:
        with self._lock:
            self._by_task[task_id] = {k: float(v) for k, v in metrics.items()}
        return True

    def get_metrics(self, task_id: str) -> dict[str, float]:
        with self._lock:
            return dict(self._by_task.get(task_id, {}))
