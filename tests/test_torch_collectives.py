"""``tony_tpu_torch.parallel.collectives`` against the JAX package's
``tony_tpu/parallel/collectives.py``: the same numpy array, cut into
blocks over a (data, fsdp) mesh, goes through each JAX collective under
``shard_map`` on the virtual CPU devices and through the port's on 2 and
4 gloo ranks (``torch_mesh_ranks``, one spawn a world), each along dims
0 and 1, over one axis and over the (data, fsdp) tuple. Every sum here
has at most four fp32 operands of a few units, integers or halves, so
the results are exact and held bit for bit."""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as JP

from tony_tpu.parallel import collectives as jcol
from torch_mesh_ranks import Ranks

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

X = np.arange(16 * 32, dtype=np.float32).reshape(16, 32) / 2.0
AXES = ["data", "fsdp", ("data", "fsdp")]
# (op, dims)
OPS = [("sum", (0, 1)), ("mean", (0, 1)), ("gather", (0, 1)),
       ("scatter", (0, 1)), ("shift", (0,)), ("tree", (0,)),
       ("stack", (0,))]
WORLDS = {2: {"data": 1, "fsdp": 2}, 4: {"data": 2, "fsdp": 2}}


def _calls():
    """(op, spec, axes, dim): ``spec`` cuts X over every mesh axis along
    ``dim`` (each rank a block of its own); the collective runs over
    ``axes``; ``shift`` and ``stack`` put the shift or the new axis in
    ``dim``'s place."""
    calls = []
    for op, dims in OPS:
        for dim in dims:
            spec = [None, None]
            spec[dim] = ("data", "fsdp")
            for axes in AXES:
                if op == "shift":
                    calls.append((op, tuple(spec), axes, 1))
                elif op == "stack":
                    calls.append((op, tuple(spec), axes, 0))
                else:
                    calls.append((op, tuple(spec), axes, dim))
    return calls


def _body(op, axes, dim):
    return {"sum": lambda x: jcol.all_reduce_sum(x, axes),
            "mean": lambda x: jcol.all_reduce_mean(x, axes),
            "gather": lambda x: jcol.all_gather(x, axes, axis=dim),
            "scatter": lambda x: jcol.reduce_scatter(x, axes, axis=dim),
            "shift": lambda x: jcol.ring_shift(x, axes, shift=dim),
            "tree": lambda x: _flat(jcol.grad_sync_tree(
                {"a": x, "b": x[:1] * 2}, axes)),
            "stack": lambda x: jcol.all_gather(x, axes, axis=0,
                                               tiled=False)}[op]


def _flat(t):
    return jax.numpy.concatenate([t["a"].reshape(-1),
                                  t["b"].reshape(-1)])[None]


def _jax(sizes, calls):
    """The JAX outputs of ``calls`` (one op, one spec: one shard_map)."""
    op, spec = calls[0][:2]
    n = sizes["data"] * sizes["fsdp"]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(sizes["data"],
                                                    sizes["fsdp"]),
                ("data", "fsdp"))
    if op == "tree":
        out_spec = JP(("data", "fsdp"))
    elif op == "stack":
        out_spec = JP(None, *JP(*spec))
    else:
        out_spec = JP(*spec)
    fns = [_body(o, axes, dim) for o, _, axes, dim in calls]

    def body(x):
        return tuple(f(x) for f in fns)

    check = {"check_vma": False} if "check_vma" in _SM_ARGS \
        else {"check_rep": False}
    sm = shard_map(body, mesh=mesh, in_specs=JP(*spec),
                   out_specs=(out_spec,) * len(fns), **check)
    return [np.asarray(y) for y in sm(X)]


def _sm_args():
    import inspect

    return inspect.signature(shard_map).parameters


_SM_ARGS = _sm_args()


def _assemble(results, call):
    """The ranks' local results laid out as the JAX output is: along the
    spec's dim (row-major over data, fsdp, i.e. rank order)."""
    op, spec, _, dim = call
    if op == "tree":
        return np.stack([r.reshape(-1) for r in results])
    at = spec.index(("data", "fsdp"))
    if op == "stack":
        return np.concatenate(results, axis=at + 1)
    return np.concatenate(results, axis=at)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Both worlds' ranks, started together; each test waits for them."""
    calls = _calls()
    return calls, {w: Ranks(w, [("collectives", {"sizes": WORLDS[w],
                                                 "x": X, "calls": calls}),
                                ("mesh_groups", {"sizes": WORLDS[w]})],
                            tmp_path_factory.mktemp(f"ranks{w}"))
                   for w in WORLDS}


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("op", [o for o, _ in OPS])
def test_collective_matches_jax(port, world, op):
    calls, ranks = port
    by_spec: dict = {}
    for i, call in enumerate(calls):
        if call[0] == op:
            by_spec.setdefault(call[1], []).append(i)
    wants = {}
    for idx in by_spec.values():
        wants.update(zip(idx, _jax(WORLDS[world], [calls[i] for i in idx])))
    ranks = ranks[world].results()
    for i, want in wants.items():
        call = calls[i]
        got = _assemble([r["collectives"][i] for r in ranks], call)
        assert got.shape == want.shape, (call, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=str(call))


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_groups_follow_the_flattened_coordinate(port, world):
    """Each rank's coordinate along an axis or a tuple of axes, its group
    in coordinate order, and a gather of the rank ids in that order;
    ``("fsdp", "data")`` flattens fsdp-major, as JAX does."""
    sizes = WORLDS[world]
    ranks = port[1][world].results()
    grid = np.arange(world).reshape(sizes["data"], sizes["fsdp"])
    for rank, r in enumerate(ranks):
        d, f = np.argwhere(grid == rank)[0]
        assert r["backend"] == "gloo"
        want = {"data": (d, grid[:, f].tolist()),
                "fsdp": (f, grid[d].tolist()),
                ("data", "fsdp"): (rank, grid.reshape(-1).tolist()),
                ("fsdp", "data"): (f * sizes["data"] + d,
                                   grid.T.reshape(-1).tolist())}
        for axes, (index, members) in want.items():
            got_index, got_members, gathered = r["mesh_groups"][axes]
            assert (got_index, got_members) == (index, members), axes
            assert gathered == [float(m) for m in members], axes
