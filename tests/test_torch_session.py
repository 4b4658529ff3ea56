"""The port's session model and DAG gang scheduler against the JAX
package's: the same sequences of task events (allocation, registration,
completions, policy failures) give the same session status, failure
reason, task statuses, cluster spec and client task table after every
event; the same role DAGs release the same roles in the same order and
refuse the same graphs. The cases are ``tests/test_session.py``'s and
``tests/test_scheduler.py``'s."""

import pytest

from tony_tpu import config as jax_config
from tony_tpu import scheduler as jax_scheduler
from tony_tpu import session as jax_session
from tony_tpu_torch import config as port_config
from tony_tpu_torch import scheduler as port_scheduler
from tony_tpu_torch import session as port_session

PKGS = [(jax_config, jax_session, jax_scheduler),
        (port_config, port_session, port_scheduler)]

# (roles, conf keys, events); an event is (op, *args)
SESSION_CASES = {
    "registration": ({"worker": 2}, {}, [
        ("expect", 2), ("init", "worker"), ("init", "worker"),
        ("init", "worker"), ("init", "nope"), ("register", "worker:0",
                                               "hostA:1111"),
        ("register", "worker:1", "hostB:2222"), ("done", "worker", 0, 0),
        ("done", "worker", 1, 0), ("finish",)]),
    "chief-failure": ({"worker": 2}, {}, [
        ("init", "worker"), ("init", "worker"), ("done", "worker", 0, 1)]),
    "explicit-chief": ({"chief": 1, "worker": 2}, {}, [
        ("init", "chief"), ("init", "worker"), ("init", "worker"),
        ("done", "worker", 0, 1), ("done", "chief", 0, 0),
        ("done", "worker", 1, 0), ("finish",)]),
    "non-chief-tolerated": ({"worker": 2}, {}, [
        ("init", "worker"), ("init", "worker"), ("done", "worker", 1, 1),
        ("done", "worker", 0, 0), ("finish",)]),
    "untracked-ps-crash": ({"worker": 1, "ps": 1}, {}, [
        ("init", "worker"), ("init", "ps"), ("done", "ps", 0, 1)]),
    "sidecar-crash": ({"worker": 1, "tensorboard": 1}, {}, [
        ("init", "worker"), ("init", "tensorboard"),
        ("done", "tensorboard", 0, 1), ("done", "worker", 0, 0),
        ("finish",)]),
    "stop-on-failure": ({"worker": 2, "reader": 1},
                        {"tony.application.stop-on-failure.jobtypes":
                         "reader"}, [
        ("init", "worker"), ("init", "worker"), ("init", "reader"),
        ("done", "reader", 0, 3)]),
    "fail-on-any-worker": ({"worker": 3},
                           {"tony.application.fail-on-worker-failure-"
                            "enabled": True}, [
        ("init", "worker"), ("init", "worker"), ("init", "worker"),
        ("done", "worker", 2, 1)]),
    "zero-instance-chief": ({"worker": 1, "chief": 0}, {}, [
        ("init", "worker"), ("done", "worker", 0, 1), ("finish",)]),
    "late-and-malformed": ({"worker": 1}, {}, [
        ("init", "worker"), ("register", "worker:0", "hostA:-5"),
        ("register", "worker:0", "hostA"), ("register", "worker:-1", "h:1"),
        ("register", "worker:0", "h:1"), ("done", "worker", 0, 0),
        ("register", "worker:0", "h2:2"), ("done", "worker", 0, 1),
        ("finish",)]),
    "head-actor": ({"head": 1, "actor": 2}, {}, [
        ("init", "head"), ("init", "actor"), ("init", "actor"),
        ("done", "actor", 1, 1), ("fail", "killed by client")]),
}


def _snapshot(s):
    return {"status": s.status.value, "reason": s.failure_reason,
            "finished": s.training_finished(),
            "tasks": [(t.id, t.status.name, t.exit_code, t.registered,
                       t.host_port) for t in s.all_tasks()],
            "spec": s.cluster_spec(),
            "infos": [i.to_dict() for i in s.task_infos()],
            "chief": {r: [s.is_chief(r, i) for i in range(len(ts))]
                      for r, ts in s.tasks.items()},
            "registered": (s.num_registered, s.total_expected,
                           s.all_registered())}


def _trace(pkgs, case):
    cfg, ss, _ = pkgs
    roles, keys, events = case
    conf = cfg.TonyConf()
    for r, n in roles.items():
        conf.set(f"tony.{r}.instances", n)
    for k, v in keys.items():
        conf.set(k, v)
    s = ss.Session(conf)
    out = []
    for op, *args in events:
        if op == "expect":
            s.add_expected(*args)
            res = None
        elif op == "init":
            t = s.init_task(*args)
            res = None if t is None else t.id
        elif op == "register":
            t = s.register(*args)
            res = None if t is None else t.host_port
        elif op == "done":
            res = s.on_task_completed(*args)
        elif op == "fail":
            res = s.fail(*args)
        else:
            res = s.update_session_status().value
        out.append((op, res, _snapshot(s)))
    return out


@pytest.mark.parametrize("name", list(SESSION_CASES))
def test_session_events_match_jax(name):
    got = [_trace(p, SESSION_CASES[name]) for p in PKGS]
    assert got[0] == got[1]


# (roles, depends-on, stage keys)
DAG_CASES = {
    "no-deps": ({"worker": 2, "ps": 1}, {}, {}),
    "release": ({"prep": 1, "worker": 2}, {"worker": "prep"}, {}),
    "chain": ({"a": 2, "b": 1, "c": 1}, {"b": "a", "c": "b"}, {}),
    "diamond": ({"a": 1, "b": 1, "c": 1, "d": 1},
                {"b": "a", "c": "a", "d": "b,c"}, {}),
    "stages": ({"etl": 1, "worker": 2}, {},
               {"tony.application.prepare-stage": "etl",
                "tony.application.training-stage": "worker"}),
    "stage-autofill": ({"etl": 1, "worker": 2}, {},
                       {"tony.application.prepare-stage": "etl"}),
    "stage-untracked": ({"etl": 1, "ps": 1, "worker": 1}, {},
                        {"tony.application.prepare-stage": "etl,ps",
                         "tony.application.training-stage": "worker"}),
    "cycle": ({"a": 1, "b": 1}, {"a": "b", "b": "a"}, {}),
    "unknown-dep": ({"a": 1}, {"a": "ghost"}, {}),
    "unknown-stage-role": ({"worker": 1}, {},
                           {"tony.application.prepare-stage": "et1"}),
}


def _dag(pkgs, case):
    cfg, ss, sch = pkgs
    roles, deps, stages = case
    conf = cfg.TonyConf()
    for r, n in roles.items():
        conf.set(f"tony.{r}.instances", n)
    for r, d in deps.items():
        conf.set(f"tony.{r}.depends-on", d)
    for k, v in stages.items():
        conf.set(k, v)
    session = ss.Session(conf)
    allocated = []
    try:
        sched = sch.TaskScheduler(
            session, lambda req: allocated.append(
                (req.role, req.instances)), conf)
    except sch.CycleError as e:
        return ("CycleError", str(e))
    steps = [(sched.schedule(), list(allocated),
              sorted(sched.blocked_roles()), sched.all_scheduled())]
    # complete roles in the order they were allocated until none is left
    done = set()
    while True:
        todo = [r for r, _ in allocated if r not in done
                and not session.is_untracked(r)]
        if not todo:
            break
        role = todo[0]
        done.add(role)
        for i in range(len(session.tasks[role])):
            session.init_task(role)
            session.on_task_completed(role, i, 0)
        steps.append((role, sched.on_role_instance_completed(role),
                      list(allocated), sorted(sched.blocked_roles()),
                      sched.all_scheduled()))
    return steps


@pytest.mark.parametrize("name", list(DAG_CASES))
def test_dag_release_matches_jax(name):
    got = [_dag(p, DAG_CASES[name]) for p in PKGS]
    assert got[0] == got[1]
