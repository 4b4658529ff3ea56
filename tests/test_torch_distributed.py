"""``tony_tpu_torch.distributed`` against ``tony_tpu.distributed``: the
same injected env gives the same spec, and a 2-worker gang through the
port's mini cluster initializes ``torch.distributed`` over gloo from it
and all_reduces across both ranks (the counterpart of the JAX package's
``test_jax_distributed_psum_e2e``, which is run beside it), with the
agents releasing the rendezvous port before the payload starts and with
them holding it across (``tony.task.reuse-port``), where rank 0's TCP
store must still bind it."""

import os

import pytest

from tony_tpu import distributed as jax_dist
from tony_tpu_torch import distributed as port_dist
from torch_jobs import TORCH_SCRIPTS, run_job, script

ENVS = [
    {},
    {"TONY_JAX_COORDINATOR": "h0:1234"},
    {"TONY_JAX_COORDINATOR": "h0:1234", "TONY_PROCESS_ID": "3",
     "TONY_NUM_PROCESSES": "4",
     "CLUSTER_SPEC": '{"worker": ["h0:1234", "h1:1", "h2:2", "h3:3"]}',
     "TONY_JOB_NAME": "worker", "TONY_TASK_INDEX": "3",
     "TONY_IS_CHIEF": "false"},
    {"TONY_JAX_COORDINATOR": "c:9", "TONY_JOB_NAME": "chief",
     "TONY_TASK_INDEX": "0", "TONY_IS_CHIEF": "true"},
]
NAMES = ("TONY_JAX_COORDINATOR", "TONY_PROCESS_ID", "TONY_NUM_PROCESSES",
         "CLUSTER_SPEC", "TONY_JOB_NAME", "TONY_TASK_INDEX",
         "TONY_IS_CHIEF")


@pytest.mark.parametrize("env", ENVS, ids=["none", "addr", "gang", "chief"])
def test_env_spec_matches_jax(env, monkeypatch):
    for k in NAMES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert port_dist.env_spec() == jax_dist.env_spec()
    assert port_dist.task_identity() == jax_dist.task_identity()
    assert port_dist.is_chief() == jax_dist.is_chief()


def test_single_process_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    for k in NAMES:
        monkeypatch.delenv(k, raising=False)
    assert port_dist.initialize() is None
    monkeypatch.setenv("TONY_JAX_COORDINATOR", "h0:1")
    assert port_dist.initialize()["num_processes"] == 1
    assert not dist.is_initialized()


def test_a_gang_without_a_gpu_needs_the_cpu_request(monkeypatch):
    monkeypatch.setenv("TONY_JAX_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("TONY_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_dist.initialize()


def _gang(name: str, reuse: bool):
    def build(cluster, mini):
        conf = mini.script_conf(cluster, name, {"worker": 2})
        conf.set("tony.task.reuse-port", reuse)
        return conf
    return build


@pytest.mark.parametrize("reuse", [False, True],
                         ids=["released", "reuse-port"])
def test_gloo_gang_all_reduces(reuse):
    got = run_job("port", _gang(os.path.join(
        TORCH_SCRIPTS, "check_torch_allreduce.py"), reuse))
    assert got["status"] == "SUCCEEDED", got
    assert got["exit_codes"] == {"worker:0": [0], "worker:1": [0]}
    if not reuse:
        ref = run_job("jax", _gang(script("check_jax_psum.py"), False))
        assert ref["status"] == "SUCCEEDED"
        assert {k: ref[k] for k in ("tasks", "exit_codes", "event_types")} \
            == {k: got[k] for k in ("tasks", "exit_codes", "event_types")}


def test_profiler_port_starts_no_server(tmp_path, monkeypatch, caplog):
    """With ``TONY_PROFILER_PORT`` set, the JAX ``initialize`` starts
    jax's profiler server; ``torch.profiler`` has none, so the port's
    logs that once and leaves the port unbound."""
    import logging
    import socket

    from tony_tpu_torch.profiler import maybe_start_server
    from tony_tpu_torch.profiler import profiler as port_profiler

    monkeypatch.setattr(port_profiler, "_no_server_logged", False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k in NAMES:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TONY_PROFILER_PORT", str(port))
    monkeypatch.chdir(tmp_path)
    with caplog.at_level(logging.INFO, logger="tony_tpu_torch.profiler"):
        assert port_dist.initialize() is None
        assert maybe_start_server() == 0
    said = [r for r in caplog.records if "no remote-capture server" in
            r.getMessage()]
    assert len(said) == 1
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))  # nothing listens on it
    assert os.listdir(tmp_path) == []
