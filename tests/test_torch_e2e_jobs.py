"""Jobs through the port's control plane against the same jobs through
the JAX package's: client -> coordinator -> agent subprocesses on this
host, payload scripts as assertions (the cases of ``tests/test_e2e.py``
that succeed). Each job runs through both packages' mini clusters with
the same conf (the port's with ``device="cpu"``); the final status and
reason, each task's status and exit code, the history's event types in
order and the keys of the final conf must agree."""

import os

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


# each pair of jobs under its own limit: a hang fails its case alone,
# well inside the suite's clock (a pair takes a few seconds here)
LIMIT = 150.0


def test_ps_and_workers_alike():
    """tests/test_e2e.py:283: an untracked ps beside two tracked workers;
    the job ends when the workers do (the ps's own end races the stop,
    so the workers decide)."""
    def build(cluster, mini):
        conf = cluster.base_conf()
        conf.set("tony.ps.instances", 1)
        conf.set("tony.worker.instances", 2)
        conf.set("tony.ps.command", f"python {script('sleep_5.py')}")
        conf.set("tony.worker.command", f"python {script('check_env.py')}")
        return conf

    got = run_both(build, tasks={"worker:0", "worker:1"}, limit=LIMIT)
    assert got["ok"] and got["status"] == "SUCCEEDED"
    assert got["exit_codes"] == {"worker:0": [0], "worker:1": [0]}


def test_resources_localized_alike():
    """tests/test_e2e.py:304: a plain file, a renamed file and an
    archive, each in the task's working directory."""
    import zipfile

    def build(cluster, mini):
        res = os.path.join(cluster.root, "res")
        os.makedirs(res)
        plain = os.path.join(res, "data.txt")
        with open(plain, "w") as f:
            f.write("x")
        archive = os.path.join(res, "bundle.zip")
        with zipfile.ZipFile(archive, "w") as z:
            z.writestr("inner.txt", "y")
        conf = cluster.base_conf()
        conf.set("tony.worker.instances", 1)
        conf.set("tony.worker.resources",
                 f"{plain},{plain}::renamed.txt,{archive}::bundle#archive")
        conf.set("tony.worker.command",
                 "test -f data.txt -a -f renamed.txt -a -f bundle/inner.txt")
        return conf

    got = run_both(build, limit=LIMIT)
    assert got["ok"] and got["exit_codes"] == {"worker:0": [0]}


def test_venv_interpreter_alike():
    """tests/test_e2e.py:327: the task runs under the shipped venv's
    interpreter (a shim that marks the environment)."""
    import stat
    import sys

    def build(cluster, mini):
        venv_bin = os.path.join(cluster.root, "venv", "bin")
        os.makedirs(venv_bin)
        shim = os.path.join(venv_bin, "python")
        with open(shim, "w") as f:
            f.write("#!/bin/bash\nexport TONY_VENV_MARK=1\n"
                    f"exec {sys.executable} \"$@\"\n")
        os.chmod(shim, os.stat(shim).st_mode | stat.S_IEXEC)
        conf = cluster.base_conf()
        conf.set("tony.application.python-venv", os.path.dirname(venv_bin))
        conf.set("tony.worker.instances", 1)
        conf.set("tony.application.executes", script("check_venv_mark.py"))
        return conf

    got = run_both(build, limit=LIMIT)
    assert got["ok"] and got["exit_codes"] == {"worker:0": [0]}


def test_fcfs_alike():
    """tests/test_e2e.py:467: FCFS scheduling (the tensorflow runtime
    hosts it) starts tasks without waiting for the gang."""
    def build(cluster, mini):
        conf = mini.script_conf(cluster, script("exit_0.py"), {"worker": 2},
                                framework="tensorflow")
        conf.set("tony.application.distributed-mode", "FCFS")
        return conf

    got = run_both(build, limit=LIMIT)
    assert got["ok"] and got["status"] == "SUCCEEDED"


def test_preprocess_parameters_reach_the_workers_alike(tmp_path):
    """tests/test_e2e.py:480: the preprocess command's scraped 'Model
    parameters: ' line reaches the workers as MODEL_PARAMS."""
    prep = tmp_path / "prep.py"
    prep.write_text("print('preprocess warming up')\n"
                    "print('Model parameters: ' + str(6 * 7))\n")
    worker = tmp_path / "worker.py"
    worker.write_text("import os, sys\n"
                      "sys.exit(0 if os.environ.get('MODEL_PARAMS') == '42' "
                      "else 9)\n")

    def build(cluster, mini):
        conf = mini.script_conf(cluster, str(worker), {"worker": 2})
        conf.set("tony.application.enable-preprocess", True)
        conf.set("tony.coordinator.command", f"python3 {prep}")
        return conf

    got = run_both(build, limit=LIMIT)
    assert got["ok"] and got["status"] == "SUCCEEDED"
    assert got["exit_codes"] == {"worker:0": [0], "worker:1": [0]}
