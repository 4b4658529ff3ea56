"""Ranks for the mesh tests: ``spawn(world, cases, tmp)`` runs this file
in ``world`` processes on the CPU, each initializing ``torch.distributed``
over gloo through ``tony_tpu_torch.distributed.initialize`` and the env a
tony-tpu job injects, then running every case of ``cases`` in one go
(one spawn, several cases) and saving what each returned. The parent
waits for every rank with a deadline, kills them all when it passes,
and on any failure raises with each rank's exit code and the tail of
its output. A rank imports the port only, never JAX: the test that
spawned it holds the results against the JAX package. ``Ranks`` starts
them and returns at once, so a test computes the JAX side meanwhile.

Each case is a function below, called with the keyword arguments the
test gave it (tensors and numpy arrays travel through ``torch.save``)."""

import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Ranks:
    """``world`` rank processes running ``cases`` ([(name, kwargs)]);
    ``results()`` waits for them (within ``timeout`` seconds of the
    start) and returns each rank's ``{name: result}``, by rank."""

    def __init__(self, world: int, cases: list, tmp, timeout: float = 120.0):
        import torch

        self.tmp, self.world, self.timeout = str(tmp), world, timeout
        os.makedirs(self.tmp, exist_ok=True)
        job = os.path.join(self.tmp, "job.pt")
        torch.save(cases, job)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self.procs, self.logs = [], []
        for r in range(world):
            env = {**os.environ,
                   "PYTHONPATH": os.pathsep.join([ROOT, HERE]),
                   "TONY_JAX_COORDINATOR": f"127.0.0.1:{port}",
                   "TONY_PROCESS_ID": str(r),
                   "TONY_NUM_PROCESSES": str(world)}
            log = open(os.path.join(self.tmp, f"rank{r}.log"), "w+")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, __file__, job,
                 os.path.join(self.tmp, f"out{r}.pt")],
                env=env, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT))
        self.deadline = time.monotonic() + timeout
        self._out = None

    def results(self) -> list:
        import torch

        if self._out is not None:
            return self._out
        rcs = []
        for p in self.procs:
            try:
                rcs.append(p.wait(
                    timeout=max(self.deadline - time.monotonic(), 0.1)))
            except subprocess.TimeoutExpired:
                rcs.append(f"killed after {self.timeout:.0f} s")
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tails = []
        for r, log in enumerate(self.logs):
            log.seek(0)
            tails.append(f"rank {r} exit {rcs[r]}:\n{log.read()[-3000:]}")
            log.close()
        if any(rc != 0 for rc in rcs):
            raise AssertionError("mesh ranks failed\n" + "\n".join(tails))
        self._out = [torch.load(os.path.join(self.tmp, f"out{r}.pt"),
                                weights_only=False)
                     for r in range(self.world)]
        return self._out


def spawn(world: int, cases: list, tmp, timeout: float = 120.0) -> list:
    """``Ranks(...).results()``: run ``cases`` and wait for them."""
    return Ranks(world, cases, tmp, timeout).results()


# ------------------------------------------------------------------ cases


def _mesh(sizes: dict):
    from tony_tpu_torch.parallel import MeshSpec, make_mesh

    return make_mesh(MeshSpec(**sizes), device_type="cpu")


def collectives(sizes: dict, x, calls: list) -> list:
    """Each call ``(op, spec, axes, dim)`` on this rank's block of ``x``
    (``spec`` cuts it, ``parallel.sharding.place``): the collective's
    result on this rank."""
    import torch

    from tony_tpu_torch.parallel import collectives as col
    from tony_tpu_torch.parallel.sharding import NamedSharding, P, place

    mesh = _mesh(sizes)
    full = torch.from_numpy(x)
    out = []
    for op, spec, axes, dim in calls:
        local = place(full, NamedSharding(mesh, P(*spec)))
        if op == "sum":
            got = col.all_reduce_sum(local, axes, mesh)
        elif op == "mean":
            got = col.all_reduce_mean(local, axes, mesh)
        elif op == "gather":
            got = col.all_gather(local, axes, mesh, axis=dim)
        elif op == "stack":
            got = col.all_gather(local, axes, mesh, axis=dim, tiled=False)
        elif op == "scatter":
            got = col.reduce_scatter(local, axes, mesh, axis=dim)
        elif op == "shift":
            got = col.ring_shift(local, axes, mesh, shift=dim)
        elif op == "tree":
            got = col.grad_sync_tree({"a": local, "b": local[:1] * 2},
                                     axes, mesh)
            got = torch.cat([got["a"].reshape(-1), got["b"].reshape(-1)])
        assert got.is_contiguous(), op
        out.append(got.numpy())
    return out


def mesh_groups(sizes: dict) -> dict:
    """This rank's coordinate and group members along each axis and the
    (data, fsdp) tuple, and a gather of the rank ids in that order."""
    import torch

    from tony_tpu_torch.parallel.collectives import all_gather

    mesh = _mesh(sizes)
    out = {}
    for axes in ("data", "fsdp", ("data", "fsdp"), ("fsdp", "data")):
        _, members = mesh.axis_group(axes)
        me = torch.tensor([float(torch.distributed.get_rank())])
        out[axes] = (mesh.axis_index(axes), members,
                     all_gather(me, axes, mesh).tolist())
    return out


def adamw(sizes: dict, params, grads, spec, lr, wd, steps,
          compute) -> dict:
    """Sharded ``fused_adamw_update`` on this rank's shards of the whole
    leaves, ``steps`` times; the masters (and compute copies) gathered."""
    import torch

    from tony_tpu_torch.ops.adamw import FusedAdamW, fused_adamw_update
    from tony_tpu_torch.parallel.sharding import (NamedSharding, P, gather,
                                                  place)

    mesh = _mesh(sizes)
    sh = NamedSharding(mesh, P(*spec))
    opt = FusedAdamW(learning_rate=lr, weight_decay=wd)
    p = {n: place(torch.from_numpy(v), sh) for n, v in params.items()}
    g = {n: place(torch.from_numpy(v), sh) for n, v in grads.items()}
    cdt = torch.bfloat16 if compute else None
    state = opt.init(p, compute_dtype=cdt)
    for _ in range(steps):
        fused_adamw_update(opt, g, state, p, mesh=mesh,
                           param_specs={n: sh.spec for n in p},
                           compute_dtype=cdt)
    out = {"params": {n: gather(t, sh) for n, t in p.items()},
           "elements": fused_adamw_update.elements}
    if compute:
        out["compute"] = {n: gather(t, sh).float()
                          for n, t in state.compute_params.items()}
    return out


def _model(kw: dict, weights: dict):
    import torch

    from tony_tpu_torch.models.transformer import (Transformer,
                                                   TransformerConfig)

    model = Transformer(TransformerConfig(dtype=torch.float32, **kw),
                        device="cpu")
    model.load_state_dict(weights)
    return model


def _apply(model, batch):
    from tony_tpu_torch.ops.xent import chunked_cross_entropy

    hidden = model(batch["tokens"], return_hidden=True)
    return chunked_cross_entropy(hidden[:, :-1], model.embedding,
                                 batch["tokens"][:, 1:], chunk_size=40)


def _specs(tree) -> dict:
    """A tree of ``NamedSharding`` as plain spec tuples, by key."""
    return {k: tuple(v.spec) for k, v in tree.items()}


def trainer(kw: dict, weights: dict, sizes: dict, fsdp: bool, accum: int,
            batches: list, lr: float) -> dict:
    """The port's ``Trainer`` over the mesh ``sizes`` with the gradient
    norm logged: each rank steps on its rows of each global batch (rows
    p::P, the loader's stride); the losses, the norms, the gathered
    masters, which leaves were sharded and ``state_shardings``' specs."""
    import torch

    from tony_tpu_torch.ops.adamw import FusedAdamW
    from tony_tpu_torch.train import Trainer

    mesh = _mesh(sizes)
    rank, world = torch.distributed.get_rank(), mesh.size()
    tr = Trainer(_model(kw, weights), _apply, FusedAdamW(lr), fsdp=fsdp,
                 accum_steps=accum, mesh=mesh, log_grad_norm=True)
    state = tr.init_state()
    losses, norms = [], []
    for b in batches:
        state, m = tr.step(state, {"tokens": torch.from_numpy(
            b[rank::world])})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    whole = tr.gather_state(state)
    sh = tr.state_shardings(state)
    return {"losses": losses, "grad_norms": norms, "params": whole.params,
            "sharded": sorted(tr._shards),
            "count": int(state.opt_state.count),
            "shardings": {"step": tuple(sh.step.spec),
                          "params": _specs(sh.params),
                          "mu": _specs(sh.opt_state.mu),
                          "nu": _specs(sh.opt_state.nu),
                          "count": tuple(sh.opt_state.count.spec)}}


def _loader(data, gb: int, seed: int, one: bool):
    from tony_tpu_torch.data import ArraySource, DataLoader

    kw = dict(process_index=0, process_count=1) if one else {}
    return DataLoader(ArraySource({"tokens": data}), gb, seed=seed,
                      device="cpu", **kw)


def exact_gate(kw: dict, weights: dict, data, micro: int, steps: int,
               lr: float, fsdp: bool, ckpt: str | None = None,
               optim: str = "fused") -> dict:
    """``fit`` on every rank at ``accum_steps=1`` over ``data_parallel``
    (fsdp: ``MeshSpec(data=1, fsdp=world)``), ``micro`` rows a rank; on
    rank 0 also the one-process ``fit`` at ``accum_steps=world`` over the
    same loader order (one process, the whole global batch). With
    ``ckpt``: the ranks' run checkpoints every step there, then the last
    half is rerun from the middle step's checkpoint, on the ranks and on
    rank 0 alone (one process, ``accum_steps=world``). ``optim`` is
    ``fused`` (``FusedAdamW``) or ``torch`` (``torch.optim.AdamW``, whose
    state's shardings come back too)."""
    import functools

    import torch

    from tony_tpu_torch.ops.adamw import FusedAdamW
    from tony_tpu_torch.parallel import MeshSpec, make_mesh
    from tony_tpu_torch.train import CheckpointManager, Trainer, fit

    world = torch.distributed.get_world_size()
    gb = micro * world
    mesh = make_mesh(MeshSpec(data=1, fsdp=world) if fsdp else MeshSpec(),
                     device_type="cpu")

    def optimizer():
        if optim == "torch":
            return functools.partial(torch.optim.AdamW, lr=lr)
        return FusedAdamW(lr)

    def ranks_fit(directory=None, total=steps):
        tr = Trainer(_model(kw, weights), _apply, optimizer(),
                     fsdp=fsdp, mesh=mesh)
        res = fit(tr, None, _loader(data, gb, 7, False), total_steps=total,
                  checkpoint_dir=directory, checkpoint_every=1 if directory
                  else 0, log_every=1)
        return ([h["loss"] for h in res.history if "loss" in h],
                tr.gather_state(res.state).params, tr, res.state)

    def one_fit(directory=None):
        tr = Trainer(_model(kw, weights), _apply, optimizer(),
                     accum_steps=world)
        res = fit(tr, None, _loader(data, gb, 7, True), total_steps=steps,
                  checkpoint_dir=directory, log_every=1)
        return [h["loss"] for h in res.history if "loss" in h], \
            res.state.params, res.resumed_from

    losses, params, tr, state = ranks_fit()
    out = {"losses": losses, "sharded": sorted(tr._shards)}
    if optim == "torch":
        sh = tr.state_shardings(state)
        out["shardings"] = {"params": _specs(sh.params), "opt": {
            i: {k: tuple(v.spec) for k, v in st.items()}
            for i, st in sh.opt_state.items()}, "names": list(state.params)}
    rank = torch.distributed.get_rank()
    if rank == 0:
        out["params"] = params
        out["one_losses"], out["one_params"], _ = one_fit()
    if ckpt is not None:
        half = steps // 2
        ranks_fit(ckpt, total=half)
        keep = CheckpointManager(ckpt)
        assert keep.latest_step() == half, keep.steps()
        resumed, params2, _, _ = ranks_fit(ckpt)
        out["resumed_losses"] = resumed
        if rank == 0:
            out["resumed_params"] = params2
        torch.distributed.barrier()
        if rank == 0:
            # the ranks' files from the middle step, resumed alone
            import shutil

            alone = ckpt + "-alone"
            shutil.copytree(os.path.join(ckpt, str(half)),
                            os.path.join(alone, str(half)))
            l1, p1, start = one_fit(alone)
            out["alone"] = {"losses": l1, "params": p1, "from": start}
        torch.distributed.barrier()
    return out


CASES = {"collectives": collectives, "mesh_groups": mesh_groups,
         "adamw": adamw, "trainer": trainer, "exact_gate": exact_gate}


def main(job: str, out_path: str) -> int:
    import torch

    from tony_tpu_torch import distributed

    torch.set_num_threads(2)
    spec = distributed.initialize(timeout_s=60, device="cpu")
    cases = torch.load(job, weights_only=False)
    out = {"backend": spec["backend"]}
    for name, kwargs in cases:
        key = kwargs.pop("key", name)
        out[key] = CASES[name](**kwargs)
    torch.save(out, out_path)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [ROOT, HERE]
    sys.exit(main(*sys.argv[1:]))
