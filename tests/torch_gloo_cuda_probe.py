"""Which ``torch.distributed`` collectives the ``gloo`` backend takes on
CUDA tensors, on the machine it runs on: for each collective, two ranks
(processes) that share one card over gloo, as ranks that outnumber the
visible cards do, call it once on CUDA tensors. The answer is ``ok``
(the result checked), ``wrong``, the error it raised, or how the ranks
died (gloo aborts the process when it is handed a device pointer it
cannot write). Each collective runs in a pair of its own, so one that
kills its ranks does not hide the others. Also a ``DeviceMesh`` of two
named dims over the pair, and an all-reduce's milliseconds at 64 MB
on the card and staged through page-locked host memory.
``parallel/collectives.py`` reads from this which collective it stages
through the host on a gloo group (send/recv, in ``ring_shift``).

    python3 tests/torch_gloo_cuda_probe.py
"""

import datetime
import json
import socket
import subprocess
import sys
import time

OPS = ("all_reduce", "all_gather", "all_gather_into_tensor",
       "reduce_scatter", "reduce_scatter_tensor", "broadcast", "send_recv",
       "device_mesh", "timing")


def rank_main(rank: int, world: int, port: int, op: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    store = dist.TCPStore("127.0.0.1", port, world, rank == 0,
                          datetime.timedelta(seconds=30))
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=30))
    dev = "cuda"
    base = torch.arange(4, dtype=torch.float32)
    full = torch.arange(4 * world, dtype=torch.float32)
    gathered = torch.cat([base + r for r in range(world)])
    scattered = (full * world + sum(range(world))).chunk(world)[rank]

    def all_reduce():
        x = (base + rank).to(dev)
        dist.all_reduce(x)
        return x, base * world + sum(range(world))

    def all_gather():
        x = (base + rank).to(dev)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return torch.cat(parts), gathered

    def all_gather_into_tensor():
        x = (base + rank).to(dev)
        o = torch.empty(4 * world, device=dev)
        dist.all_gather_into_tensor(o, x)
        return o, gathered

    def reduce_scatter():
        x = (full + rank).to(dev)
        o = torch.empty(4, device=dev)
        dist.reduce_scatter(o, list(x.chunk(world)))
        return o, scattered

    def reduce_scatter_tensor():
        x = (full + rank).to(dev)
        o = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(o, x)
        return o, scattered

    def broadcast():
        x = (base + rank).to(dev)
        dist.broadcast(x, 0)
        return x, base

    def send_recv():
        x = (base + rank).to(dev)
        o = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
               dist.P2POp(dist.irecv, o, (rank - 1) % world)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return o, base + (rank - 1) % world

    def device_mesh():
        from torch.distributed.device_mesh import DeviceMesh

        m = DeviceMesh("cuda", torch.arange(world).reshape(1, world),
                       mesh_dim_names=("data", "fsdp"))
        return None, dist.get_world_size(m.get_group("fsdp"))

    def timing():
        big = torch.ones(16 << 20, device=dev)  # 64 MB of fp32
        out = {}
        for how in ("direct", "staged", "direct", "staged"):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if how == "direct":
                dist.all_reduce(big)
            else:
                host = big.to("cpu", copy=True).pin_memory()
                dist.all_reduce(host)
                big.copy_(host)
            torch.cuda.synchronize()
            out.setdefault(how, []).append(
                round((time.perf_counter() - t0) * 1e3, 1))
        return None, out

    fn = locals()[op]
    try:
        got, want = fn()
        torch.cuda.synchronize()
        if got is None:
            answer = f"ok: {want}"
        else:
            answer = "ok" if torch.equal(got.cpu(), want) \
                else f"wrong: {got.cpu().tolist()}"
    except Exception as e:  # noqa: BLE001 (the probe's answer)
        answer = f"{type(e).__name__}: {str(e)[:200]}"
    print(json.dumps({"op": op, "rank": rank, "answer": answer}),
          flush=True)
    dist.barrier()
    dist.destroy_process_group()


def pair(op: str, world: int = 2, limit: float = 40.0) -> list:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                               str(world), str(port), op],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + limit
    out = []
    for p in procs:
        try:
            text, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 0.1))
            rc = p.returncode
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
            rc = f"killed after {limit:.0f} s"
        lines = [ln for ln in text.splitlines() if ln.startswith("{")]
        out.append({"rc": rc, "said": lines[-1] if lines else
                    text.strip().splitlines()[-1:] or ""})
    return out


def main() -> int:
    import torch

    print("torch", torch.__version__, "cuda", torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    for op in OPS:
        print(op, json.dumps(pair(op)), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5])
    else:
        sys.exit(main())
