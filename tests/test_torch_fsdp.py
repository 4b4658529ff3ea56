"""Data-parallel and FSDP training of the port over gloo ranks, against the
JAX package on its virtual CPU devices and against the port's own one
process:

- sharded ``fused_adamw_update`` (the spec ``P(("data", "fsdp"), None)``
  of ``tests/test_adamw.py``, a compute copy) against the JAX function's
  sharded form, on 4 ranks;
- ``Trainer`` on the meshes (data=2), (data=1, fsdp=2) and (data=2,
  fsdp=2), fsdp on and off, ``accum_steps`` 1 and 2, fp32, 3 steps,
  against the JAX ``Trainer`` on the same mesh shape, weights carried by
  ``models.convert``;
- the exact gate: 2 ranks at ``accum_steps=1`` equal one process at
  ``accum_steps=2`` over the same loader, bit for bit, fsdp on and off;
- a sharded checkpoint written on 2 ranks resumed on 2 ranks and on one
  process, bit-equal to the uninterrupted runs;
- a 2-worker ``lm_pretrain`` job through the port's mini cluster on the
  CPU, its losses equal to one process's ``fit`` at ``accum_steps=2``.

Ranks run in ``torch_mesh_ranks`` processes, one spawn a world, started
before the JAX side is computed.

Tolerances. Losses 1e-5 (``test_torch_train.py``'s). Params: rtol 1e-4,
atol 2e-5, the JAX package's own fsdp-against-replicated bound
(``tests/test_adamw.py:145-147``). The ranks reorder the gradient sums
(two or four partial sums a step, against XLA's order), and AdamW divides
each gradient by its own magnitude, so an element whose gradient is a
rounding-sized remainder moves by up to lr a step whatever its rounding.
``tests/torch_trainer_probe.py`` measures that carry on this draw at lr
1e-3: a +-u nudge of every gradient element (u = 2^-24) moves
``attn.k.bias``, whose gradient is zero in exact arithmetic (a constant
added to every key shifts all of a query's scores alike), by up to
1.3e-4, and every other leaf by at most 7.8e-7; the port on one device
ends 1.3e-4 from JAX there. At lr 1e-3 the JAX package's own runs part
by that much too: its (2, 2)-mesh and one-device params differ by 3.1e-5
at one embedding element, over the bound's atol. So these steps run at
lr 1e-4, where the carry (a few lr-sized steps of noise at most) sits
under the bound: the ranks end within 0.76 of it on every leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

from torch_mesh_ranks import Ranks
from torch_parity import QWEN_TINY, build_pair, tokens
from tony_tpu.ops.adamw import FusedAdamW as JaxFusedAdamW
from tony_tpu.ops.adamw import fused_adamw_update as jax_update
from tony_tpu.ops.xent import chunked_cross_entropy as jax_xent
from tony_tpu.train import Trainer as JaxTrainer
from tony_tpu_torch.models.convert import from_jax_params

# wide enough that shard_params_by_size (leaves of 2^14+ elements) shards
# the embedding, the attention and MLP kernels, and replicates the rest
MESH_KW = dict(vocab_size=256, d_model=128, n_heads=4, n_kv_heads=2,
               d_ff=256)
LR = 1e-4
SEQ = 17
GB = 8  # global batch rows
MESHES = {"data2": {"data": 2, "fsdp": 1}, "fsdp2": {"data": 1, "fsdp": 2},
          "data2fsdp2": {"data": 2, "fsdp": 2}}
CASES = [(m, f, a) for m in MESHES for f in (False, True) for a in (1, 2)]


def _batches():
    return [tokens(100 + i, (GB, SEQ), MESH_KW["vocab_size"])
            for i in range(3)]


def _adamw_inputs():
    rng = np.random.default_rng(5)
    params = {"big": (rng.standard_normal((256, 1024)) * 0.02).astype(
        np.float32)}
    grads = {"big": (np.sin(params["big"] * 50) * 0.1).astype(np.float32)}
    return params, grads


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The draw, and both worlds' ranks started on it."""
    jm, jparams, tm = build_pair(0, **MESH_KW)
    weights = {k: v.clone() for k, v in tm.state_dict().items()}
    kw = {**QWEN_TINY, **MESH_KW}
    batches = _batches()
    params, grads = _adamw_inputs()
    data = tokens(7, (GB, SEQ), MESH_KW["vocab_size"])
    by_world = {2: [], 4: []}
    for m, f, a in CASES:
        world = MESHES[m]["data"] * MESHES[m]["fsdp"]
        by_world[world].append(("trainer", {
            "key": (m, f, a), "kw": kw, "weights": weights,
            "sizes": MESHES[m], "fsdp": f, "accum": a, "batches": batches,
            "lr": LR}))
    by_world[4].append(("adamw", {
        "sizes": {"data": 2, "fsdp": 2}, "params": params, "grads": grads,
        "spec": (("data", "fsdp"), None), "lr": 3e-4, "wd": 1e-2,
        "steps": 2, "compute": True}))
    for fsdp in (False, True):
        by_world[2].append(("exact_gate", {
            "key": ("exact", fsdp), "kw": kw, "weights": weights,
            "data": data, "micro": GB // 2, "steps": 4, "lr": LR,
            "fsdp": fsdp,
            "ckpt": str(tmp_path_factory.mktemp(f"ckpt{int(fsdp)}"))}))
    by_world[2].append(("exact_gate", {
        "key": ("exact", True, "torch"), "kw": kw, "weights": weights,
        "data": data, "micro": GB // 2, "steps": 2, "lr": LR, "fsdp": True,
        "optim": "torch", "ckpt": str(tmp_path_factory.mktemp("ckpt_opt"))}))
    ranks = {w: Ranks(w, cases, tmp_path_factory.mktemp(f"fsdp{w}"),
                      timeout=150)
             for w, cases in by_world.items()}
    return {"jm": jm, "jparams": jparams, "cfg": tm.cfg, "ranks": ranks,
            "start": weights}


def _jax_mesh(sizes):
    n = sizes["data"] * sizes["fsdp"]
    return Mesh(np.array(jax.devices()[:n]).reshape(sizes["data"],
                                                    sizes["fsdp"]),
                ("data", "fsdp"))


_JAX_RUNS: dict = {}


def _jax_run(jm, jparams, sizes, fsdp, accum):
    """The JAX Trainer's losses, params, gradient norms and the markers
    of its ``state_shardings`` (``_jax_steps``); fsdp without an fsdp
    axis shards nothing, so that run is the run without fsdp (cached)."""
    key = (tuple(sorted(sizes.items())), fsdp and sizes["fsdp"] > 1, accum)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _jax_steps(jm, jparams, sizes, fsdp, accum)
    return _JAX_RUNS[key]


def _jax_steps(jm, jparams, sizes, fsdp, accum):
    def apply_fn(p, batch):
        hidden = jm.apply(p, batch["tokens"], return_hidden=True)
        return jax_xent(hidden[:, :-1], p["params"]["embedding"],
                        batch["tokens"][:, 1:], chunk_size=40)

    tr = JaxTrainer(mesh=_jax_mesh(sizes), apply_fn=apply_fn,
                    optimizer=JaxFusedAdamW(LR), donate=False, fsdp=fsdp,
                    accum_steps=accum, log_grad_norm=True)
    state = tr.init_state({"params": jparams})
    sh = tr.state_shardings(state)

    def markers(tree, shardings):
        return jax.tree.map(
            lambda x, s: _marker(tuple(s.spec), sizes, x.shape), tree,
            shardings)

    shardings = {"step": tuple(sh.step.spec),
                 "params": markers(state.params, sh.params),
                 "mu": markers(state.opt_state.mu, sh.opt_state.mu),
                 "nu": markers(state.opt_state.nu, sh.opt_state.nu),
                 "count": tuple(sh.opt_state.count.spec)}
    step_fn, placed = tr.build_step(state)
    losses, norms = [], []
    for b in _batches():
        placed, m = step_fn(placed, {"tokens": jnp.asarray(b, jnp.int32)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, placed.params, norms, shardings


def _marker(spec, sizes, shape) -> np.ndarray:
    """Each element's shard under ``spec`` on a mesh of ``sizes``: its
    coordinate along the mesh axes that cut it (0 everywhere when
    nothing does). Carried through ``from_jax_params`` with the JAX
    leaves, it compares partitions across the two layouts."""
    out = np.zeros(shape, np.float32)
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = int(np.prod([sizes.get(a, 1) for a in axes if a is not None]))
        if n > 1:
            idx = np.arange(shape[d]) // (shape[d] // n)
            out = out * n + idx.reshape(
                [-1 if i == d else 1 for i in range(len(shape))])
    return out


@pytest.mark.parametrize("mesh,fsdp,accum", CASES)
def test_trainer_matches_jax_on_the_same_mesh(setup, mesh, fsdp, accum):
    sizes = MESHES[mesh]
    jl, jp, _, _ = _jax_run(setup["jm"], setup["jparams"], sizes, fsdp,
                            accum)
    world = sizes["data"] * sizes["fsdp"]
    ranks = setup["ranks"][world].results()
    got = [r[(mesh, fsdp, accum)] for r in ranks]
    # every rank logs the same (averaged) loss and holds the same masters
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"]
        for n, t in r["params"].items():
            assert torch.equal(t, got[0]["params"][n]), n
    np.testing.assert_allclose(got[0]["losses"], jl, rtol=0, atol=1e-5)
    want = from_jax_params(jax.tree.map(np.asarray, jp), setup["cfg"])
    for n, w in want.items():
        np.testing.assert_allclose(got[0]["params"][n].numpy(), w.numpy(),
                                   rtol=1e-4, atol=2e-5, err_msg=n)
    assert got[0]["count"] == 3
    # fsdp shards the big leaves over a size-2 fsdp axis, and only there
    sharded = got[0]["sharded"]
    if fsdp and sizes["fsdp"] > 1:
        assert {"embedding", "blocks.0.mlp.wi.weight",
                "blocks.0.attn.q.weight"} <= set(sharded)
        assert "blocks.0.attn.k.weight" not in sharded  # 2^13 elements
        assert "ln_f.scale" not in sharded
    else:
        assert sharded == []


@pytest.mark.parametrize("mesh,fsdp,accum", CASES)
def test_grad_norm_matches_jax(setup, mesh, fsdp, accum):
    """``log_grad_norm``: the norm of the summed gradients (under fsdp the
    local shards' squares summed over the shard axes) against the JAX
    ``Trainer``'s ``optax.global_norm``, each step, to 1e-5 relative (the
    losses' bound: the norms, like the losses, differ by the gradient
    sums' order and the params' 3-step drift)."""
    sizes = MESHES[mesh]
    _, _, jn, _ = _jax_run(setup["jm"], setup["jparams"], sizes, fsdp,
                           accum)
    world = sizes["data"] * sizes["fsdp"]
    got = [r[(mesh, fsdp, accum)]["grad_norms"]
           for r in setup["ranks"][world].results()]
    assert all(g == got[0] for g in got[1:])
    np.testing.assert_allclose(got[0], jn, rtol=1e-5, atol=0)


@pytest.mark.parametrize("mesh,fsdp", [(m, f) for m in MESHES
                                       for f in (False, True)])
def test_state_shardings_match_jax(setup, mesh, fsdp):
    """``Trainer.state_shardings``: each param's and moment's partition
    (``_marker``, carried through ``from_jax_params`` on the JAX side)
    against the JAX ``Trainer.state_shardings``' on the same mesh; the
    step and the count replicated. Both apply ``shard_params_by_size``'s
    rule (the largest divisible dim, the first on a tie) to their own
    layout, and a port ``Linear`` weight is ``[out, in]`` where the JAX
    kernel is ``[in, ...]``: where in and out tie (``attn.q``, 128 by
    128 here) the port cuts the out dim and JAX the in dim, into as many
    shards of the same size. So a leaf whose largest dim is unique has
    the JAX partition, and a tied one the same shard count and size."""
    sizes = MESHES[mesh]
    _, _, _, js = _jax_run(setup["jm"], setup["jparams"], sizes, fsdp, 1)
    world = sizes["data"] * sizes["fsdp"]
    got = setup["ranks"][world].results()[0][(mesh, fsdp, 1)]["shardings"]
    assert got["step"] == got["count"] == js["step"] == js["count"] == ()
    shapes = {n: tuple(t.shape) for n, t in setup["start"].items()}
    for part in ("params", "mu", "nu"):
        want = from_jax_params(js[part], setup["cfg"])
        assert set(got[part]) == set(want)
        for n, w in want.items():
            mine = _marker(got[part][n], sizes, shapes[n])
            big = [d for d in shapes[n] if d == max(shapes[n], default=0)]
            if len(big) == 1:
                np.testing.assert_array_equal(mine, w.numpy(),
                                              err_msg=f"{part} {n}")
            else:
                assert sorted(np.unique(mine, return_counts=True)[1]) == \
                    sorted(np.unique(w.numpy(), return_counts=True)[1]), n
    cut = [n for n, sp in got["params"].items() if sp]
    assert bool(cut) == (fsdp and sizes["fsdp"] > 1)


def test_torch_optim_fsdp_equals_one_process_and_resumes(setup):
    """A ``torch.optim.AdamW`` ``Trainer`` under fsdp on 2 ranks: the
    exact gate (bit-equal to one process at ``accum_steps=2``), its
    checkpoint (the optimizer's state gathered whole) resumed on 2 ranks
    and on one process bit-equal to the uninterrupted runs, and
    ``state_shardings`` giving each moment its param's sharding and the
    step count none."""
    ranks = setup["ranks"][2].results()
    got = [r[("exact", True, "torch")] for r in ranks]
    zero = got[0]
    assert zero["sharded"]
    assert zero["losses"] == got[1]["losses"] == zero["one_losses"]
    for n, t in zero["one_params"].items():
        assert torch.equal(zero["params"][n], t), n
    assert len(zero["losses"]) == 2  # a checkpoint after step 1
    assert zero["resumed_losses"] == got[1]["resumed_losses"] \
        == zero["losses"][1:]
    for n, t in zero["params"].items():
        assert torch.equal(zero["resumed_params"][n], t), n
    alone = zero["alone"]
    assert alone["from"] == 1 and alone["losses"] == zero["losses"][1:]
    for n, t in zero["one_params"].items():
        assert torch.equal(alone["params"][n], t), n
    sh = zero["shardings"]
    for i, st in sh["opt"].items():
        spec = sh["params"][sh["names"][i]]
        assert st["exp_avg"] == st["exp_avg_sq"] == spec
        assert st["step"] == ()
    assert any(sh["params"][n] for n in zero["sharded"])


def test_sharded_fused_adamw_matches_jax(setup, monkeypatch):
    """The JAX update under shard_map (its kernel forced on, as
    ``tests/test_adamw.py`` forces it) on a (2, 2) mesh against the port's
    on 4 ranks' shards: masters and compute copies gathered, with
    ``test_torch_adamw.py``'s tolerances."""
    monkeypatch.setenv("TONY_FUSED_ADAMW_MIN_ELEMS", "1024")
    params, grads = _adamw_inputs()
    mesh = _jax_mesh({"data": 2, "fsdp": 2})
    opt = JaxFusedAdamW(learning_rate=3e-4, weight_decay=1e-2)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    jg = {n: jnp.asarray(v) for n, v in grads.items()}
    state = opt.init(jp, compute_dtype=jnp.bfloat16)
    specs = {"big": JP(("data", "fsdp"), None)}
    for _ in range(2):
        jp, state = jax_update(opt, jg, state, jp, mesh=mesh,
                               param_specs=specs,
                               compute_dtype=jnp.bfloat16)
    ranks = setup["ranks"][4].results()
    got = ranks[0]["adamw"]
    assert got["elements"] == (256 * 1024 // 4, 256 * 1024)
    np.testing.assert_allclose(got["params"]["big"].numpy(),
                               np.asarray(jp["big"]), rtol=2e-6, atol=3e-7)
    want_c = np.asarray(state.compute_params["big"].astype(jnp.float32))
    np.testing.assert_allclose(got["compute"]["big"].numpy(), want_c,
                               rtol=2.0 ** -7, atol=0)
    for r in ranks[1:]:
        assert torch.equal(r["adamw"]["params"]["big"], got["params"]["big"])


@pytest.mark.parametrize("fsdp", [False, True])
def test_two_ranks_equal_one_process_at_accum_two(setup, fsdp):
    """The DataLoader gives rank p the rows order[p::2], which are
    micro-batch p of the one process's strided split at accum 2; the
    ranks' fp32 sum of two gradients and its 1/2 are the one process's
    accumulation bit for bit, and AdamW is elementwise."""
    ranks = setup["ranks"][2].results()
    got = [r[("exact", fsdp)] for r in ranks]
    assert got[0]["losses"] == got[1]["losses"] == got[0]["one_losses"]
    assert len(got[0]["losses"]) == 4
    for n, t in got[0]["one_params"].items():
        assert torch.equal(got[0]["params"][n], t), n
    assert bool(got[0]["sharded"]) == fsdp


@pytest.mark.parametrize("fsdp", [False, True])
def test_sharded_checkpoint_resumes_on_two_ranks_and_on_one(setup, fsdp):
    ranks = setup["ranks"][2].results()
    got = [r[("exact", fsdp)] for r in ranks]
    zero = got[0]
    # 2 ranks: from step 2's checkpoint to step 4
    assert zero["resumed_losses"] == zero["losses"][2:]
    assert got[1]["resumed_losses"] == zero["losses"][2:]
    for n, t in zero["params"].items():
        assert torch.equal(zero["resumed_params"][n], t), n
    # one process, accum 2, from the ranks' step-2 file
    alone = zero["alone"]
    assert alone["from"] == 2 and alone["losses"] == zero["losses"][2:]
    for n, t in zero["one_params"].items():
        assert torch.equal(alone["params"][n], t), n


def test_two_worker_lm_pretrain_job_equals_one_process(tmp_path):
    """``examples/lm_pretrain.py`` on a 2-worker gang (gloo, the CPU):
    each worker ``--micro 2 --accum 1`` on ``data_parallel_mesh()``, the
    losses equal to one process's ``fit`` at micro 2, accum 2."""
    import json
    import os

    import test_torch_job_train as job_tests
    from torch_jobs import ROOT, run_job

    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(job_tests.TINY))
    size = ["--micro", "2", "--accum", "1"] + job_tests.SIZE[4:]
    result = tmp_path / "r{rank}.json"

    def build(cluster, mini):
        conf = mini.script_conf(
            cluster, os.path.join(ROOT, "tony_tpu_torch", "examples",
                                  "lm_pretrain.py"), {"worker": 2})
        conf.set("tony.application.task-params", " ".join([
            "--config-json", str(cfg), *size, "--steps", "4",
            "--result", str(result)]))
        return conf

    got = run_job("port", build)
    assert got["status"] == "SUCCEEDED", got
    res = [json.loads((tmp_path / f"r{r}.json").read_text())
           for r in (0, 1)]
    want = [h["loss"] for h in job_tests._in_process(4).history
            if "loss" in h]
    for r, doc in enumerate(res):
        assert doc["rank"] == r and doc["world"] == 2
        assert doc["backend"] == "gloo"
        assert doc["losses"] == want  # bit-equal
        assert doc["tokens_per_step"] == 2 * 2 * 16
