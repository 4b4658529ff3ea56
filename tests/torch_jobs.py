"""Shared set-up for the tests that run one job through both packages'
control planes (``tony_tpu.mini`` and ``tony_tpu_torch.mini``) with the
same conf, and compare what each left behind."""

import contextlib
import json
import os
import re
import signal

from tony_tpu import mini as jax_mini
from tony_tpu.events import history as jax_history
from tony_tpu_torch import mini as port_mini
from tony_tpu_torch.events import history as port_history

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SCRIPTS = os.path.join(HERE, "scripts")
TORCH_SCRIPTS = os.path.join(HERE, "torch_scripts")
PACKAGES = {"jax": (jax_mini, jax_history, {}),
            "port": (port_mini, port_history, {"device": "cpu"})}


def script(name: str) -> str:
    return os.path.join(SCRIPTS, name)


def _exit_codes(job_dir: str) -> dict:
    """{task id: [exit codes]} the coordinators logged, every attempt."""
    out: dict = {}
    path = os.path.join(job_dir, "logs", "coordinator.log")
    with open(path, errors="replace") as f:
        for m in re.finditer(r"task (\S+) registered exit code (-?\d+)",
                             f.read()):
            out.setdefault(m.group(1), []).append(int(m.group(2)))
    return out


def run_job(pkg: str, build, tasks=None) -> dict:
    """Run the job that ``build(cluster, mini_module)`` configures through
    ``pkg``'s mini cluster: its final status and reason, each task's
    status and logged exit codes, the history's event types in order (of
    the application and of ``tasks``, or of every task) and the keys of
    the final conf. ``tasks`` names the tasks whose fate the job decides;
    a case that races others (a quick exit beside a failing chief) leaves
    them out."""
    mini, history, kw = PACKAGES[pkg]
    with mini.MiniTonyCluster(**kw) as cluster:
        conf = build(cluster, mini)
        client = cluster.make_client(conf)
        ok = client.run()
        with open(os.path.join(client.job_dir, "status.json")) as f:
            status = json.load(f)
        with open(os.path.join(client.job_dir, "tony-final.json")) as f:
            final_keys = sorted(json.load(f))
        jobs = history.list_jobs(os.path.join(cluster.root, "history"))
        events = []
        for e in history.parse_events(jobs[0]["jhist"]):
            who = e.payload.get("taskType"), e.payload.get("taskIndex")
            task = None if who[0] is None else f"{who[0]}:{who[1]}"
            if task is None or tasks is None or task in tasks:
                events.append((e.type.value, task or "",
                               e.payload.get("status") or ""))
        codes = _exit_codes(client.job_dir)
    keep = (lambda t: True) if tasks is None else (lambda t: t in tasks)
    return {"ok": ok, "status": client.final_status["status"],
            "reason": client.final_status.get("reason") or "",
            "tasks": sorted((f"{t['name']}:{t['index']}", t["status"])
                            for t in status["tasks"]
                            if keep(f"{t['name']}:{t['index']}")),
            "exit_codes": {t: c for t, c in sorted(codes.items())
                           if keep(t)},
            "history_status": jobs[0]["status"],
            # the types in order; with who and what, as a multiset (two
            # tasks of a gang may finish in either order)
            "event_types": [e[0] for e in events],
            "events": sorted(events),
            "final_conf_keys": final_keys}


class JobTimeLimit(Exception):
    """A job pair ran past its time limit (``run_both``'s ``limit``)."""


@contextlib.contextmanager
def time_limit(seconds: float):
    """Raise ``JobTimeLimit`` in the test's thread once ``seconds`` pass:
    a case that hangs fails alone instead of holding the whole suite's
    clock. The mini cluster's exit still stops its processes."""
    def expire(signum, frame):
        raise JobTimeLimit(f"the job pair ran past {seconds:.0f} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def run_both(build, tasks=None, limit: float | None = None) -> dict:
    """``run_job`` through the JAX package and the port, within ``limit``
    seconds for the pair when given; asserts they agree and returns the
    port's."""
    with time_limit(limit) if limit else contextlib.nullcontext():
        got = {pkg: run_job(pkg, build, tasks) for pkg in PACKAGES}
    assert got["port"] == got["jax"]
    return got["port"]
