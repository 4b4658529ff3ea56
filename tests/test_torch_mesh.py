"""``tony_tpu_torch.parallel.mesh`` and ``sharding`` against the JAX
package's, in one process: the port's meshes over ranks 0..7 (no process
group: the spec math) beside the JAX meshes over the 8 virtual CPU
devices (``tests/conftest.py``), the same shapes through both packages'
functions, and each port spec equal to the JAX one, entry for entry.
The collectives and the local-shard functions run on gloo ranks in
``test_torch_collectives.py`` and ``test_torch_fsdp.py``."""

import jax
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from tony_tpu.parallel import mesh as jmesh
from tony_tpu.parallel import sharding as jsh
from tony_tpu_torch import distributed
from tony_tpu_torch.parallel import mesh as pmesh
from tony_tpu_torch.parallel import sharding as psh

SPECS = [pmesh.MeshSpec(), pmesh.MeshSpec(data=2, fsdp=4),
         pmesh.MeshSpec(data=-1, fsdp=2), pmesh.MeshSpec(data=1, fsdp=-1),
         pmesh.MeshSpec(data=2, fsdp=2, tensor=2),
         pmesh.MeshSpec(data=1, fsdp=2, tensor=2, pipe=2)]


def _jspec(spec):
    return jmesh.MeshSpec(**vars(spec))


def _pair(spec, drop_trivial=False):
    """(port mesh over ranks 0..7, JAX mesh over the 8 devices)."""
    return (pmesh.make_mesh(spec, devices=range(8),
                            drop_trivial=drop_trivial, device_type="cpu"),
            jmesh.make_mesh(_jspec(spec), drop_trivial=drop_trivial))


def _ids(jax_mesh):
    return np.vectorize(lambda d: d.id)(jax_mesh.devices)


def _same(p, j):
    """A port spec equals a JAX spec entry for entry."""
    assert tuple(p) == tuple(j), (p, j)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 6])
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_resolve_matches_jax(spec, n):
    try:
        want = _jspec(spec).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            spec.resolve(n)
        assert str(got.value) == str(e)
        return
    assert spec.resolve(n) == want


def test_resolve_refuses_two_wildcards():
    for s in (pmesh.MeshSpec(data=-1, fsdp=-1), jmesh.MeshSpec(data=-1,
                                                               fsdp=-1)):
        with pytest.raises(ValueError, match="at most one wildcard"):
            s.resolve(8)


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("spec", SPECS[1:], ids=str)
def test_make_mesh_names_shapes_and_order(spec, drop):
    p, j = _pair(spec, drop)
    assert isinstance(p, DeviceMesh)
    assert p.mesh_dim_names == j.axis_names == p.axis_names
    assert p.shape == dict(j.shape)
    np.testing.assert_array_equal(p.devices, _ids(j))
    assert pmesh.mesh_axis_size(p, "fsdp") == jmesh.mesh_axis_size(j, "fsdp")
    assert pmesh.mesh_axis_size(p, "nope") == 1 == \
        jmesh.mesh_axis_size(j, "nope")


def test_data_parallel_and_default_meshes():
    p = pmesh.data_parallel_mesh(range(8), device_type="cpu")
    j = jmesh.data_parallel_mesh()
    assert p.shape == dict(j.shape) == {"data": 8}
    # a world of one process: a mesh of size 1, talking to nobody
    one = distributed.default_mesh(device="cpu")
    assert one.shape == {"data": 1} and one.size() == 1
    assert one.axis_group("data") == (None, [0])
    assert one.axis_index(("data", "fsdp")) == 0
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("axis", ["data", "fsdp"])
def test_multislice_virtual_slices_match_jax(axis):
    spec = pmesh.MeshSpec(data=-1, fsdp=2)
    p = pmesh.multislice_mesh(spec, devices=range(8), dcn_axis=axis,
                              n_slices=2, device_type="cpu")
    j = jmesh.multislice_mesh(_jspec(spec), dcn_axis=axis, n_slices=2)
    assert p.shape == dict(j.shape)
    np.testing.assert_array_equal(p.devices, _ids(j))
    assert pmesh.num_slices(range(8)) == jmesh.num_slices() == 1
    single = pmesh.multislice_mesh(spec, devices=range(8),
                                   device_type="cpu")
    assert single.shape == dict(jmesh.multislice_mesh(_jspec(spec)).shape)
    with pytest.raises(ValueError, match="slices"):
        pmesh.multislice_mesh(spec, devices=range(8), n_slices=3,
                              device_type="cpu")


LOGICAL = [("batch", "seq"), ("embed", "mlp"), ("mlp", "embed"),
           ("heads", "kv", "embed"), ("vocab", "embed"), (None, "embed"),
           ("expert", "embed", "mlp"), ("layers", "embed", "heads", "kv"),
           ("kv_heads", "kv", "embed"), ("act_seq",), ()]


def test_rules_are_the_jax_presets():
    assert psh.RULES == jsh.RULES
    assert psh._SERVE_FLIP_AXES == jsh._SERVE_FLIP_AXES


@pytest.mark.parametrize("preset", sorted(jsh.RULES))
def test_spec_for_serve_spec_for_and_tree_shardings(preset):
    rules = jsh.RULES[preset]
    for axes in LOGICAL:
        _same(psh.spec_for(axes, rules), jsh.spec_for(axes, rules))
        _same(psh.serve_spec_for(axes, rules),
              jsh.serve_spec_for(axes, rules))
    p, j = _pair(pmesh.MeshSpec(data=2, fsdp=2, tensor=2))
    tree = {"a": ("embed", "mlp"), "b": {"c": ("heads", "kv", "embed")}}
    pt, jt = psh.tree_shardings(p, tree, preset), \
        jsh.tree_shardings(j, tree, preset)
    _same(pt["a"].spec, jt["a"].spec)
    _same(pt["b"]["c"].spec, jt["b"]["c"].spec)


SHAPES = {"embedding": (151936 // 64, 1536 // 8), "wi": (192, 1120),
          "odd": (999, 33), "small": (64, 64), "bias": (256,),
          "three": (4, 4096, 12), "scalar": ()}


@pytest.mark.parametrize("spec", SPECS[1:], ids=str)
@pytest.mark.parametrize("min_size", [2 ** 14, 16])
def test_shard_params_by_size_matches_jax(spec, min_size):
    p, j = _pair(spec)
    pt = psh.shard_params_by_size(
        p, {k: torch.zeros(s) for k, s in SHAPES.items()},
        min_size=min_size)
    jt = jsh.shard_params_by_size(
        j, {k: np.zeros(s, np.float32) for k, s in SHAPES.items()},
        min_size=min_size)
    for k in SHAPES:
        _same(pt[k].spec, jt[k].spec)
        assert pt[k].shard_shape(SHAPES[k]) == jt[k].shard_shape(SHAPES[k])
    if spec.fsdp > 1 and min_size == 2 ** 14:  # replicated by rule
        assert tuple(pt["odd"].spec) == ()  # no dim divisible by fsdp
        assert tuple(pt["small"].spec) == ()  # under min_size


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_batch_replicated_and_validated_specs(spec):
    if spec.resolve(8) != _jspec(spec).resolve(8):
        pytest.skip("not a mesh of 8")
    p, j = _pair(spec)
    _same(psh.batch_sharding(p).spec, jsh.batch_sharding(j).spec)
    _same(psh.replicated(p).spec, jsh.replicated(j).spec)
    for want_spec, shape in [(("data", "fsdp"), (6, 8)),
                             ((("data", "fsdp"), "tensor"), (8, 3)),
                             ((None, ("fsdp", "tensor")), (5, 16)),
                             (("tensor",), (4, 4, 4))]:
        _same(psh.validated_spec(p, psh.P(*want_spec), shape),
              jsh.validated_spec(j, jsh.P(*want_spec), shape))
        assert psh._axis_size(p, want_spec[0]) == \
            jsh._axis_size(j, want_spec[0])


def _cache(kvh: int, scaled: bool, lib):
    leaves = {"cached_key": (2, 4, 16, kvh, 8),
              "cached_value": (2, 4, 16, kvh, 8)}
    if scaled:
        leaves.update(cached_key_scale=(2, 4, 16, kvh),
                      cached_value_scale=(2, 4, 16, kvh))
    make = (lambda s: torch.zeros(s, dtype=torch.bfloat16)) \
        if lib == "torch" else (lambda s: np.zeros(s, np.float32))
    out = {"layers": {k: make(s) for k, s in leaves.items()},
           "cache_index": make(())}
    return out


@pytest.mark.parametrize("kvh", [2, 3, 4])
@pytest.mark.parametrize("scaled", [False, True])
def test_kv_cache_shardings_and_counts_match_jax(kvh, scaled):
    p, j = _pair(pmesh.MeshSpec(data=2, fsdp=2, tensor=2))
    pc, jc = _cache(kvh, scaled, "torch"), _cache(kvh, scaled, "np")
    ps, js = psh.kv_cache_shardings(p, pc), jsh.kv_cache_shardings(j, jc)
    _same(ps["cache_index"].spec, js["cache_index"].spec)
    for k in pc["layers"]:
        _same(ps["layers"][k].spec, js["layers"][k].spec)
    assert psh.kv_shard_count(p, pc) == jsh.kv_shard_count(j, jc)
    # per-device bytes and counts: bf16 leaves in the port, fp32 in JAX
    assert psh.tree_shard_count(pc, ps) == jsh.tree_shard_count(jc, js)
    assert 2 * psh.tree_shard_bytes(pc, ps) == jsh.tree_shard_bytes(jc, js)


def test_shard_shape_and_tree_shard_bytes_of_params():
    p, j = _pair(pmesh.MeshSpec(data=2, fsdp=4))
    params = {k: torch.zeros(s) for k, s in SHAPES.items()}
    ps = psh.shard_params_by_size(p, params, min_size=16)
    js = jsh.shard_params_by_size(
        j, {k: np.zeros(s, np.float32) for k, s in SHAPES.items()},
        min_size=16)
    assert psh.tree_shard_bytes(params, ps) == jsh.tree_shard_bytes(
        {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}, js)
    assert psh.tree_shard_count(params, ps) < sum(
        int(np.prod(s)) for s in SHAPES.values())
    with pytest.raises(ValueError, match="does not split"):
        psh.NamedSharding(p, psh.P("fsdp")).shard_shape((6,))


def test_collectives_need_a_process_group():
    p, _ = _pair(pmesh.MeshSpec(data=2, fsdp=4))
    with pytest.raises(RuntimeError, match="no process group"):
        p.axis_group("fsdp")
    assert p.axis_group("tensor")[0] is None  # a size-1 axis


def test_jax_is_on_the_cpu():
    assert jax.device_count() == 8
