"""User-facing distributed init: ``torch.distributed`` from the env a
tony-tpu job injects. The counterpart of ``tony_tpu/distributed.py``
(there over ``jax.distributed``).

A training script launched by tony-tpu calls::

    import tony_tpu_torch.distributed as dist
    dist.initialize()          # torch.distributed from injected env
    mesh = dist.default_mesh() # every rank's device, named ("data",)

The ``jax`` runtime's env serves both packages: ``TONY_JAX_COORDINATOR``
(the chief's registered ``host:port``, which becomes the TCP store's
address on rank 0), ``TONY_PROCESS_ID`` (the rank) and
``TONY_NUM_PROCESSES`` (the world size), so one ``job.toml`` runs under
either package. Safe on a single process with no env: a no-op.
"""

from __future__ import annotations

import atexit
import datetime
import json
import logging
import os
import socket
import time

from tony_tpu_torch import constants as C

log = logging.getLogger(__name__)


def env_spec() -> dict | None:
    """The injected rendezvous env, or None outside a tony-tpu task."""
    addr = os.environ.get(C.COORDINATOR_ADDRESS)
    if not addr:
        return None
    return {
        "coordinator_address": addr,
        "process_id": int(os.environ.get(C.PROCESS_ID, "0")),
        "num_processes": int(os.environ.get(C.NUM_PROCESSES, "1")),
        "cluster_spec": json.loads(os.environ.get(C.CLUSTER_SPEC, "{}")),
    }


def _card_id() -> str:
    """The identity of the card this process drives (its UUID)."""
    import torch

    return str(torch.cuda.get_device_properties(
        torch.cuda.current_device()).uuid)


def _backend(device: str | None, store=None, rank: int = 0,
             world: int = 1) -> tuple[str, str]:
    """(backend, why): ``gloo`` on an explicit CPU request, or when the
    ranks outnumber the cards (two ranks drive one card: every rank
    publishes the UUID of its current card in the store, and any UUID
    seen twice means a shared card, which NCCL refuses); ``nccl`` when
    each rank has a card of its own. Without a store it only checks that
    a GPU is there: it raises with no GPU and no CPU request, as the
    port's other entry points do."""
    if device == "cpu":
        return "gloo", "device=cpu"
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to initialize over gloo")
    if store is None:
        return "nccl", "one rank"
    store.set(f"tony/card/{rank}", _card_id())
    cards = [store.get(f"tony/card/{r}").decode() for r in range(world)]
    if len(set(cards)) < world:
        return "gloo", (f"{world} ranks on {len(set(cards))} card(s): "
                        "ranks share a card")
    return "nccl", f"{world} ranks, a card each"


def _local_index(store, rank: int, world: int) -> int:
    """This rank's place among the ranks on its host: every rank
    publishes its host name in the store."""
    store.set(f"tony/host/{rank}", socket.gethostname())
    hosts = [store.get(f"tony/host/{r}").decode() for r in range(world)]
    return sum(h == hosts[rank] for h in hosts[:rank])


def _store(spec: dict, timeout: datetime.timedelta):
    """The rendezvous TCP store at the coordinator address. Rank 0 serves
    it from a listening socket that it binds itself with
    ``SO_REUSEPORT``, and hands to the store: the agent may still hold the
    port (``tony.task.reuse-port``: a bound, non-listening socket, also
    ``SO_REUSEPORT``), and a store that bound the port on its own would
    then fail with ``EADDRINUSE``."""
    import torch.distributed as dist

    host, port = spec["coordinator_address"].rsplit(":", 1)
    world = spec["num_processes"]
    if spec["process_id"] != 0:
        return dist.TCPStore(host, int(port), world, False, timeout)
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    sock.bind(("", int(port)))
    sock.listen(128)
    return dist.TCPStore(host, int(port), world, True, timeout,
                         master_listen_fd=sock.detach())


def _shutdown(store, rank: int, world: int,
              timeout: datetime.timedelta) -> None:
    """At exit, the counterpart of ``jax.distributed``'s shutdown barrier:
    every rank arrives before any tears its group down (a rank that exits
    while a peer still reads from its gloo pairs aborts that peer), and
    rank 0, whose process serves the store, waits for every rank to
    leave before it exits."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return
    deadline = time.monotonic() + timeout.total_seconds()

    def count_to_world(key: str) -> None:
        store.add(key, 1)
        while store.add(key, 0) < world and time.monotonic() < deadline:
            time.sleep(0.01)

    try:
        count_to_world("tony/shutdown/arrived")
        dist.destroy_process_group()
        if rank == 0:
            count_to_world("tony/shutdown/left")
        else:
            store.add("tony/shutdown/left", 1)
    except Exception:  # noqa: BLE001 (exiting anyway: log, do not raise)
        log.warning("torch.distributed shutdown incomplete", exc_info=True)


def initialize(timeout_s: int | None = None,
               device: str | None = None) -> dict | None:
    """``torch.distributed.init_process_group`` from injected env, with an
    exit handler that tears the group down in step with the other ranks
    (``_shutdown``). Off the CPU each rank drives the card at its place
    among its host's ranks (modulo the visible cards). The backend is
    ``nccl`` when each rank has a card of its own, else ``gloo``
    (``_backend``: ``device="cpu"``, or ranks that share a card); the
    rank prints it on its first line. No-op (returns the spec, or None
    outside a job) with a single process."""
    from tony_tpu_torch.profiler import maybe_start_server

    spec = env_spec()
    if spec is None or spec["num_processes"] <= 1:
        log.info("single-process run; skipping init_process_group")
        maybe_start_server()  # the profiler port applies at any gang size
        return spec
    import torch.distributed as dist

    _backend(device)  # no GPU and no CPU request: raise before binding
    timeout = datetime.timedelta(seconds=timeout_s or 300)
    store = _store(spec, timeout)
    rank, world = spec["process_id"], spec["num_processes"]
    if device != "cpu":
        import torch

        # the rank's card: its place on the host, past the cards' count
        # sharing them
        torch.cuda.set_device(_local_index(store, rank, world)
                              % torch.cuda.device_count())
    backend, why = _backend(device, store, rank, world)
    print(f"tony_tpu_torch.distributed: rank {rank} of {world}, backend "
          f"{backend} ({why})", flush=True)
    dist.init_process_group(
        backend=backend, store=store, rank=rank, world_size=world,
        timeout=timeout)
    atexit.register(_shutdown, store, rank, world, timeout)
    log.info("torch.distributed initialized (%s): rank %d/%d via %s",
             backend, rank, world, spec["coordinator_address"])
    maybe_start_server()  # TONY_PROFILER_PORT-gated; no-op otherwise
    return {**spec, "backend": backend}


def default_mesh(axis_name: str = "data", device: str | None = None):
    """Every rank's device as a 1-D data-parallel mesh (call after
    ``initialize``): ``parallel.data_parallel_mesh``, its one dim named
    ``axis_name``, on ``device`` (``cpu``; None is the card)."""
    from tony_tpu_torch.parallel.mesh import Mesh, data_parallel_mesh

    mesh = data_parallel_mesh(device_type=device)
    if mesh.axis_names == (axis_name,):
        return mesh
    return Mesh(mesh.devices, (axis_name,), mesh.device_type)


def task_identity() -> tuple[str, int]:
    """(role, index) of this task, or ("", 0) outside a job."""
    return os.environ.get(C.JOB_NAME, ""), int(os.environ.get(C.TASK_INDEX, "0"))


def is_chief() -> bool:
    return os.environ.get(C.IS_CHIEF, "false") == "true"
