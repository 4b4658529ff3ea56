"""Failing and faulted jobs through the port's control plane against the
same jobs through the JAX package's (the failure-policy, DAG and
fault-injection cases of ``tests/test_e2e.py``). Each job runs through
both packages' mini clusters with the same conf and the same injected
fault; the final status and reason, the decisive tasks' status and exit
code, the history's event types in order and the keys of the final conf
must agree."""

from tony_tpu import constants as C
from torch_jobs import run_both, script


def _roles(commands: dict):
    def build(cluster, mini):
        conf = cluster.base_conf()
        for role, cmd in commands.items():
            conf.set(f"tony.{role}.instances", 1)
            conf.set(f"tony.{role}.command", cmd)
        return conf
    return build


def _script_job(name, roles, **keys):
    def build(cluster, mini):
        conf = mini.script_conf(cluster, script(name), roles)
        for k, v in keys.items():
            conf.set(k, v)
        return conf
    return build


def test_single_worker_failure_alike():
    got = run_both(_script_job("exit_1.py", {"worker": 1}))
    assert not got["ok"] and got["status"] == "FAILED"
    assert got["exit_codes"] == {"worker:0": [1]}


def test_chief_failure_fails_job_alike():
    got = run_both(_roles({"chief": f"python {script('exit_1.py')}",
                           "worker": f"python {script('exit_0.py')}"}),
                   tasks={"chief:0"})
    assert got["status"] == "FAILED" and "chief" in got["reason"]
    assert got["tasks"] == [("chief:0", "FAILED")]


def test_non_chief_failure_tolerated_alike():
    got = run_both(_roles({"chief": f"python {script('exit_0.py')}",
                           "failing": f"python {script('exit_1.py')}"}))
    assert got["ok"]
    assert got["exit_codes"] == {"chief:0": [0], "failing:0": [1]}


def test_untracked_failure_fails_fast_alike():
    got = run_both(_roles({"worker": f"python {script('sleep_5.py')}",
                           "ps": f"python {script('exit_1.py')}"}))
    assert got["status"] == "FAILED"
    assert got["exit_codes"] == {"ps:0": [1]}


def test_role_dag_alike(tmp_path):
    marker = tmp_path / "prep_done"

    def build(cluster, mini):
        marker.unlink(missing_ok=True)
        conf = cluster.base_conf()
        conf.set("tony.prep.instances", 1)
        conf.set("tony.worker.instances", 1)
        conf.set("tony.worker.depends-on", "prep")
        conf.set("tony.prep.command", f"touch {marker}")
        conf.set("tony.worker.command", f"test -f {marker}")
        return conf

    got = run_both(build)
    assert got["ok"]
    assert got["event_types"] == ["APPLICATION_INITED", "TASK_STARTED",
                                  "TASK_FINISHED", "TASK_STARTED",
                                  "TASK_FINISHED", "APPLICATION_FINISHED"]


def test_missed_heartbeats_alike(monkeypatch):
    """The job fails for its missed heartbeats; whether the killed
    agent's exit reaches the session before the coordinator stops is a
    race in both packages, so only the job's fate is compared."""
    monkeypatch.setenv(C.TEST_TASK_NUM_HB_MISS, "1000")
    got = run_both(_script_job("sleep_5.py", {"worker": 1},
                               **{"tony.task.max-missed-heartbeats": 3}),
                   tasks=set())
    assert got["status"] == "FAILED" and "heartbeat" in got["reason"]


def test_coordinator_exception_retry_alike(monkeypatch):
    monkeypatch.setenv(C.TEST_COORD_THROW, "1")
    got = run_both(_script_job("exit_0.py", {"worker": 1},
                               **{"tony.coordinator.retry-count": 1}))
    assert got["ok"]


def test_coordinator_exception_no_retry_alike(monkeypatch):
    monkeypatch.setenv(C.TEST_COORD_THROW, "1")
    got = run_both(_script_job("exit_0.py", {"worker": 1}))
    assert got["status"] == "FAILED" and "coordinator" in got["reason"]


def test_registration_timeout_alike(monkeypatch):
    monkeypatch.setenv(C.TEST_TASK_SKEW, "worker#0#15000")
    got = run_both(_script_job(
        "exit_0.py", {"worker": 1},
        **{"tony.coordinator.registration-timeout-ms": 1500}))
    assert got["status"] == "FAILED" and "register" in got["reason"]
