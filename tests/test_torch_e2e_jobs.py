"""Jobs through the port's control plane against the same jobs through
the JAX package's: client -> coordinator -> agent subprocesses on this
host, payload scripts as assertions (the cases of ``tests/test_e2e.py``
that succeed). Each job runs through both packages' mini clusters with
the same conf (the port's with ``device="cpu"``); the final status and
reason, each task's status and exit code, the history's event types in
order and the keys of the final conf must agree."""

import pytest

from torch_jobs import run_both, script


def _script_job(name, roles, framework="jax"):
    return lambda cluster, mini: mini.script_conf(
        cluster, script(name), roles, framework=framework)


@pytest.mark.parametrize("case", [
    ("exit_0.py", {"worker": 1}, "jax"),
    ("check_env.py", {"worker": 2}, "jax"),
    ("check_pytorch_env.py", {"worker": 2}, "pytorch"),
    ("check_tb_port_set_in_chief_only.py", {"worker": 2}, "jax"),
    ("exit_0.py", {"worker": 1}, "standalone"),
], ids=["single-worker", "gang-env", "pytorch-env", "tb-port-chief-only",
        "standalone"])
def test_job_succeeds_alike(case):
    got = run_both(_script_job(*case))
    assert got["ok"] and got["status"] == "SUCCEEDED"
    assert all(s == "FINISHED" for _, s in got["tasks"])
    assert all(c == [0] for c in got["exit_codes"].values())


def test_history_written_alike():
    got = run_both(_script_job("exit_0.py", {"worker": 1}))
    assert got["history_status"] == "SUCCEEDED"
    assert got["event_types"] == ["APPLICATION_INITED", "TASK_STARTED",
                                  "TASK_FINISHED", "APPLICATION_FINISHED"]


def test_final_conf_written_alike():
    got = run_both(_script_job("exit_0.py", {"worker": 1}))
    assert "tony.worker.instances" in got["final_conf_keys"]
    assert "tony.application.framework" in got["final_conf_keys"]
