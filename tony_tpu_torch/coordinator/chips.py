"""Per-task chip assignment on shared hosts.

The PyTorch port's copy of ``tony_tpu/coordinator/chips.py``.

Reference: ``tony.<role>.gpus`` becomes an ENFORCED container resource —
YARN hands each container its own GPU set
(HadoopCompatibleAdapter.java:71, util/Utils.java:393-419
``setCapabilityGPU``). On a shared TPU-VM host (LocalProcessLauncher /
DockerLauncher) nothing isolates tasks by default: every process sees all
chips. The ChipAllocator assigns each task a disjoint device-id set from
``tony.<role>.chips`` and the coordinator exports it as
``TPU_VISIBLE_DEVICES`` (libtpu's device-subset contract), so two tasks on
one 4-chip host with 2 chips each see 2 chips apiece. The port's
coordinator exports the same ids as ``CUDA_VISIBLE_DEVICES``; the
allocator is unchanged. Topology bounds
(TPU_PROCESS_BOUNDS etc.) stay with the runtime adapters — they depend on
the mesh, not the allocation.
"""

from __future__ import annotations

import threading


class ChipAllocator:
    """Disjoint device-id sets for tasks sharing this host's chips."""

    def __init__(self, total: int):
        self.total = max(int(total), 0)
        self._free: list[int] = list(range(self.total))
        self._held: dict[str, list[int]] = {}
        self._lock = threading.Lock()

    def allocate(self, task_id: str, n: int) -> list[int]:
        """Reserve ``n`` chips for ``task_id``. Raises RuntimeError when
        the host cannot satisfy the request (the scheduler treats that as
        an allocation failure, like an unsatisfiable container request)."""
        with self._lock:
            if task_id in self._held:  # relaunch same epoch: reuse
                return list(self._held[task_id])
            if n > len(self._free):
                raise RuntimeError(
                    f"task {task_id} wants {n} chips but only "
                    f"{len(self._free)} of {self.total} are free on this "
                    "host")
            ids, self._free = self._free[:n], self._free[n:]
            self._held[task_id] = ids
            return list(ids)

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def release(self, task_id: str) -> None:
        with self._lock:
            ids = self._held.pop(task_id, None)
            if ids:
                self._free = sorted(self._free + ids)

    def reset(self) -> None:
        """New session epoch: every previous hold is void."""
        with self._lock:
            self._free = list(range(self.total))
            self._held.clear()
