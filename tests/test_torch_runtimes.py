"""The port's runtime adapters against the JAX package's: for the same
``TaskContext`` each adapter's ``build_task_env`` is equal, multislice
env included, and the AM adapters' checks, gating and cluster specs
agree. The cases are ``tests/test_runtimes.py``'s. ``horovod`` is not
ported: the port refuses it with a ``ConfError``."""

import json

import pytest

from tony_tpu import config as jax_config
from tony_tpu import runtime as jax_runtime
from tony_tpu import session as jax_session
from tony_tpu.runtime import jax_runtime as jax_jaxrt
from tony_tpu.runtime import tf_runtime as jax_tfrt
from tony_tpu_torch import config as port_config
from tony_tpu_torch import runtime as port_runtime
from tony_tpu_torch import session as port_session
from tony_tpu_torch.runtime import jax_runtime as port_jaxrt
from tony_tpu_torch.runtime import tf_runtime as port_tfrt

PKGS = [(jax_config, jax_runtime, jax_session),
        (port_config, port_runtime, port_session)]
TWO = {"worker": ["h0:1000", "h1:1001"]}
ROLES3 = {"ps": ["p0:1"], "worker": ["w0:2", "w1:3"]}
MX = {"scheduler": ["127.0.0.1:5000"], "server": ["s0:1", "s1:2"],
      "worker": ["w0:3"]}
RAY = {"head": ["hd:6379"], "worker": ["w0:1", "w1:2"]}
SLICES = {"worker": ["h0:1111", "h1:1111", "h2:1111", "h3:1111"]}

# (framework, role, index, cluster spec, conf keys)
ENV_CASES = [
    ("jax", "worker", 1, TWO, {}),
    ("jax", "worker", 1, ROLES3, {}),
    ("jax", "worker", 0, TWO, {"tony.tpu.topology": "v5p-8"}),
    ("jax", "worker", 0, SLICES, {"tony.tpu.num-slices": 2}),
    ("jax", "worker", 2, SLICES, {"tony.tpu.num-slices": 2}),
    ("jax", "worker", 3, SLICES, {"tony.tpu.num-slices": 2}),
    ("tensorflow", "worker", 0, TWO, {}),
    ("tensorflow", "worker", 1, {**TWO, "ps": ["p0:3"],
                                 "tensorboard": ["t:4"],
                                 "evaluator": ["e:5"]}, {}),
    ("tensorflow", "worker", 0, TWO,
     {"tony.application.distributed-mode": "FCFS"}),
    ("pytorch", "worker", 1, TWO, {}),
    ("mxnet", "server", 1, MX, {}),
    ("mxnet", "worker", 0, MX, {}),
    ("standalone", "worker", 0, {"worker": ["h0:1"]}, {}),
    ("ray", "worker", 0, RAY, {}),
    ("ray", "head", 0, RAY, {}),
]


def _ctx(pkgs, framework, role, index, spec, keys, **kw):
    cfg, rt, _ = pkgs
    conf = cfg.TonyConf()
    for k, v in keys.items():
        conf.set(k, v)
    return rt.TaskContext(conf=conf, role=role, index=index,
                          task_num=len(spec.get(role, [])),
                          is_chief=role in ("chief", "worker")
                          and index == 0,
                          cluster_spec=spec, command="true", **kw)


def _env(pkgs, case):
    framework = case[0]
    try:
        return pkgs[1].get_task_adapter(framework).build_task_env(
            _ctx(pkgs, *case))
    except pkgs[0].ConfError as e:
        return ("ConfError", str(e))


@pytest.mark.parametrize("case", ENV_CASES,
                         ids=[f"{c[0]}-{c[1]}{c[2]}-{i}"
                              for i, c in enumerate(ENV_CASES)])
def test_task_env_matches_jax(case):
    got = [_env(p, case) for p in PKGS]
    assert got[0] == got[1]
    assert isinstance(got[1], dict) and got[1]["TONY_JOB_NAME"] == case[1]


def test_indivisible_multislice_refused_alike():
    case = ("jax", "worker", 0, {"worker": ["h0:1", "h1:1", "h2:1"]},
            {"tony.tpu.num-slices": 2})
    got = [_env(p, case) for p in PKGS]
    assert got[0] == got[1] and got[0][0] == "ConfError"
    assert "does not divide" in got[0][1]


def test_multislice_env_function_matches_jax():
    for pid in range(4):
        conf = [p[0].TonyConf() for p in PKGS]
        for c in conf:
            c.set("tony.tpu.num-slices", 2)
        assert jax_jaxrt.multislice_env(conf[0], SLICES, pid, 4) \
            == port_jaxrt.multislice_env(conf[1], SLICES, pid, 4)


def test_coordinator_address_and_tf_config_match_jax():
    for spec in ({"ps": ["p:1"], "chief": ["c:9"], "worker": ["w:2"]},
                 {"ps": ["p:1"], "worker": ["w:2"]}, {"head": ["h:3"]}):
        assert jax_jaxrt.coordinator_address(spec) \
            == port_jaxrt.coordinator_address(spec)
    spec = {"worker": ["w0:1", "w1:2"], "ps": ["p0:3"], "tensorboard":
            ["t:4"], "evaluator": ["e:5"]}
    for role, idx in (("worker", 1), ("evaluator", 0)):
        assert json.loads(jax_tfrt.construct_tf_config(spec, role, idx)) \
            == json.loads(port_tfrt.construct_tf_config(spec, role, idx))


# (framework, conf keys): each AM adapter's validation
VALIDATE = [("jax", {"tony.application.distributed-mode": "FCFS"}),
            ("jax", {}),
            ("mxnet", {"tony.scheduler.instances": 2}),
            ("standalone", {"tony.worker.instances": 2}),
            ("standalone", {"tony.worker.instances": 1}),
            ("ray", {"tony.worker.instances": 2}),
            ("ray", {"tony.worker.instances": 2, "tony.head.instances": 1})]


@pytest.mark.parametrize("case", VALIDATE,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(VALIDATE)])
def test_am_validation_matches_jax(case):
    framework, keys = case
    out = []
    for cfg, rt, _ in PKGS:
        conf = cfg.TonyConf()
        for k, v in keys.items():
            conf.set(k, v)
        try:
            rt.get_am_adapter(framework).validate_and_update_config(conf)
            out.append(("ok", dict(conf.items())))
        except cfg.ConfError as e:
            out.append(("ConfError", str(e)))
    assert out[0] == out[1]


def test_gang_gating_matches_jax():
    out = []
    for cfg, rt, ss in PKGS:
        conf = cfg.TonyConf()
        conf.set("tony.worker.instances", 2)
        session = ss.Session(conf)
        session.add_expected(2)
        am = rt.get_am_adapter("jax")
        am.set_session(session)
        session.init_task("worker")
        session.init_task("worker")
        session.register("worker:0", "h0:1")
        seen = [am.can_start_task("GANG", "worker:0"),
                am.can_start_task("FCFS", "worker:0")]
        session.register("worker:1", "h1:2")
        seen += [am.can_start_task("GANG", "worker:0"),
                 json.loads(am.construct_cluster_spec("worker:0"))]
        out.append(seen)
    assert out[0] == out[1] == [False, True, True,
                                {"worker": ["h0:1", "h1:2"]}]


def test_tb_port_policy_matches_jax():
    out = []
    for cfg, rt, _ in PKGS:
        adapter = rt.get_task_adapter("jax")
        conf = cfg.TonyConf()
        conf.set("tony.worker.instances", 1)
        seen = [adapter.need_reserve_tb_port("worker", True, conf),
                adapter.need_reserve_tb_port("worker", False, conf)]
        conf.set("tony.tensorboard.instances", 1)
        seen += [adapter.need_reserve_tb_port("worker", True, conf),
                 adapter.need_reserve_tb_port("tensorboard", False, conf),
                 adapter.need_reserve_rdzv_port("worker", conf)]
        out.append(seen)
    assert out[0] == out[1]


def test_unknown_framework_refused_alike():
    for _, rt, _ in PKGS:
        with pytest.raises(ValueError, match="unknown framework"):
            rt.get_runtime("caffe")


def test_horovod_refused_until_ported():
    assert jax_runtime.get_runtime("horovod").name == "horovod"
    with pytest.raises(port_config.ConfError, match="ROADMAP"):
        port_runtime.get_runtime("horovod")
    with pytest.raises(port_config.ConfError):
        port_runtime.get_am_adapter("horovod")
