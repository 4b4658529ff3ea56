"""Role-dependency gang scheduler.

The PyTorch port's copy of ``tony_tpu/scheduler/dag.py``.

Reference: TaskScheduler.java (179 LoC) — validates the role graph is a DAG,
schedules roles whose ``depends-on`` sets are satisfied, and releases
dependents as upstream roles' instances all complete. Also supports the
two-stage prepare/training split (ref: util/Utils.java:371-419
parseContainerRequests with tony.application.prepare-stage/training-stage).

This is pure logic over an abstract ``allocate`` callback; the coordinator
wires the callback to real agent placement.
"""

from __future__ import annotations

import logging
from typing import Callable

from tony_tpu_torch.config import TonyConf
from tony_tpu_torch.session import RoleRequest, Session

log = logging.getLogger(__name__)


class CycleError(ValueError):
    pass


class TaskScheduler:
    """Schedules role gangs respecting the dependency DAG."""

    def __init__(
        self,
        session: Session,
        allocate: Callable[[RoleRequest], None],
        conf: TonyConf | None = None,
    ):
        self.session = session
        self.allocate = allocate
        self.requests = dict(session.requests)
        self.deps = self._build_dependency_graph(conf)
        self.scheduled: set[str] = set()
        self.completed_roles: set[str] = set()

    # -- graph (ref: buildTaskDependencyGraph :75, isDAG :142) --------------
    def _build_dependency_graph(self, conf: TonyConf | None) -> dict[str, set[str]]:
        deps: dict[str, set[str]] = {
            role: set(req.depends_on) for role, req in self.requests.items()
        }
        # stage split: every training-stage role implicitly depends on every
        # *tracked* prepare-stage role — untracked roles (long-running ps/
        # sidecars) never "complete" and must not gate training (ref:
        # Utils.java:380 tasksToDependOn excludes untrackedJobTypes)
        if conf is not None:
            prepare_conf = conf.get_list("tony.application.prepare-stage")
            training_conf = conf.get_list("tony.application.training-stage")
            unknown = (set(prepare_conf) | set(training_conf)) - set(deps)
            if unknown:
                raise CycleError(
                    f"stage lists name unknown roles: {sorted(unknown)}")
            # one stage set, the other empty: auto-fill with the remaining
            # roles (ref: Utils.ensureStagedTasksIntegrity :431-449)
            if prepare_conf and not training_conf:
                training_conf = [r for r in deps if r not in prepare_conf]
            elif training_conf and not prepare_conf:
                prepare_conf = [r for r in deps if r not in training_conf]
            untracked = self.session.untracked | self.session.sidecars
            prepare = [r for r in prepare_conf if r not in untracked]
            for t in training_conf:
                deps[t].update(prepare)
        for role, ds in deps.items():
            unknown = ds - set(self.requests)
            if unknown:
                raise CycleError(f"role {role} depends on unknown roles: {sorted(unknown)}")
        if not self._is_dag(deps):
            raise CycleError(f"role dependency graph has a cycle: {deps}")
        return deps

    @staticmethod
    def _is_dag(deps: dict[str, set[str]]) -> bool:
        indeg = {r: len(ds) for r, ds in deps.items()}
        rdeps: dict[str, set[str]] = {r: set() for r in deps}
        for r, ds in deps.items():
            for d in ds:
                rdeps[d].add(r)
        queue = [r for r, n in indeg.items() if n == 0]
        seen = 0
        while queue:
            r = queue.pop()
            seen += 1
            for dep in rdeps[r]:
                indeg[dep] -= 1
                if indeg[dep] == 0:
                    queue.append(dep)
        return seen == len(deps)

    # -- scheduling (ref: scheduleTasks :55, scheduleJob :93) ---------------
    def schedule(self) -> list[str]:
        """Schedule every role whose dependencies are satisfied; returns the
        roles scheduled this call."""
        newly: list[str] = []
        for role, req in self.requests.items():
            if role in self.scheduled:
                continue
            if self.deps[role] <= self.completed_roles:
                log.info("scheduling role %s (%d instances)", role, req.instances)
                self.session.add_expected(req.instances)
                self.allocate(req)
                self.scheduled.add(role)
                newly.append(role)
        return newly

    # -- release (ref: registerDependencyCompleted :118) --------------------
    def on_role_instance_completed(self, role: str) -> list[str]:
        """Mark progress; if all instances of ``role`` completed, re-run
        scheduling and return any newly released roles."""
        slots = self.session.tasks.get(role)
        if slots is None:
            return []
        if all(t is not None and t.completed for t in slots):
            self.completed_roles.add(role)
            return self.schedule()
        return []

    def all_scheduled(self) -> bool:
        return self.scheduled == set(self.requests)

    def blocked_roles(self) -> set[str]:
        return set(self.requests) - self.scheduled
