"""Deterministic fault injection for the serving engine: a copy of
``tony_tpu/serve/faults.py``, the same module free of JAX, kept apart so
the port imports nothing of the JAX package.

A ``FaultPlan`` is a list of pre-declared faults. The port's ``Server``
hooks it where device work starts: ``on_dispatch()`` at the top of
``step()``, ``on_admit(request_id)`` before an admission's prefill. So
a test or a smoke script can say "the 3rd step dies" or "this request
wedges for two seconds" and get the same failure on every run. A fired
fault is never caught inside the engine: ``InjectedFault`` (a plain
``RuntimeError``) reaches the caller of ``step()``, which recovers with
``Server.reset()``.

Two delivery routes: the constructor (``Server(...,
fault_plan=FaultPlan.fail_at(3))``) and the environment
(``TONY_SERVE_FAULTS`` holds a JSON fault list, parsed by
``FaultPlan.from_env(replica=i)``).

Fault spec fields (JSON object or ``Fault`` kwargs):

  op        engine side: "fail" (raise ``InjectedFault``) or "wedge"
            (sleep: a stalled, not crashed, dispatch). Transport side
            (for a remote-replica stub's HTTP layer): "refuse"
            (``ConnectionRefusedError``), "blackhole" (optional
            ``seconds`` delay, then ``TimeoutError``), "delay" (sleep
            ``seconds``, then proceed), "disconnect"
            (``ConnectionResetError`` mid-stream), "half_open" (fires on
            stream reads: ``seconds`` delay then ``TimeoutError``)
  dispatch  fire on ``step()`` calls numbered >= this (1-based count
            per engine)
  call      fire on transport calls numbered >= this (1-based count per
            stub)
  request   fire when this engine request id is admitted, or, transport
            side, when the stub submits or streams this id
  seconds   wedge/delay/black-hole duration
  times     firings before the fault is spent (default 1; -1 = every
            match)
  replica   restrict an env fault to one replica index (None = all)

One ``TONY_SERVE_FAULTS`` value can mix both kinds: the engine arms
``FaultPlan.from_env`` (engine ops only) and a transport stub arms
``FaultPlan.transport_from_env`` (transport ops only).
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Any

log = logging.getLogger(__name__)

ENV_VAR = "TONY_SERVE_FAULTS"

# engine-side ops (hooked at Server.step()/admission) vs transport-side
# ops (hooked at the remote stub's HTTP layer) — one env var carries
# both, each consumer arms only its own kind
ENGINE_OPS = frozenset({"fail", "wedge"})
TRANSPORT_OPS = frozenset({"refuse", "blackhole", "delay", "disconnect",
                           "half_open"})
# transport ops that fire on the per-call hook vs the per-stream-read
# hook (half_open = the connection opened, the body never arrives).
# blackhole fires on BOTH: a partitioned host's already-open streams
# stop delivering exactly like its new connections do.
_CALL_OPS = frozenset({"refuse", "blackhole", "delay"})
_STREAM_OPS = frozenset({"disconnect", "half_open", "delay", "blackhole"})


class InjectedFault(RuntimeError):
    """The deterministic stand-in for a dead dispatch. Deliberately a
    plain ``RuntimeError`` subclass: supervision must treat it exactly
    like a real failure, or the tests prove nothing."""


@dataclass
class Fault:
    """One pre-declared failure. See the module docstring for field
    semantics; a fault needs at least one trigger (``dispatch`` or
    ``request``)."""

    op: str = "fail"
    dispatch: int | None = None
    call: int | None = None
    request: Any = None
    seconds: float = 0.0
    times: int = 1
    replica: int | None = None

    def __post_init__(self):
        if self.op not in ENGINE_OPS | TRANSPORT_OPS:
            raise ValueError(
                f"fault op must be one of "
                f"{sorted(ENGINE_OPS | TRANSPORT_OPS)}, got {self.op!r}")
        if self.dispatch is None and self.call is None \
                and self.request is None:
            raise ValueError(
                "fault needs a trigger: dispatch, call or request")
        if self.op in ENGINE_OPS and self.call is not None:
            raise ValueError(
                f"engine fault {self.op!r} cannot use the transport "
                f"'call' trigger (use 'dispatch' or 'request')")
        if self.op in TRANSPORT_OPS and self.dispatch is not None:
            raise ValueError(
                f"transport fault {self.op!r} cannot use the engine "
                f"'dispatch' trigger (use 'call' or 'request')")
        if self.op in ("wedge", "delay") and self.seconds <= 0:
            raise ValueError(f"{self.op} fault needs seconds > 0")


class FaultPlan:
    """The engine-side hook object: owns its faults plus a dispatch
    counter (one per engine — probes advance it too, so a spent fault
    lets the breaker probe succeed while ``times=-1`` keeps a replica
    down through every probe)."""

    def __init__(self, faults):
        self.faults = list(faults)
        self.n_dispatches = 0
        self.n_calls = 0
        self.fired = 0

    # --------------------------------------------------- construction

    @classmethod
    def from_env(cls, replica: int | None = None, env=None,
                 ops: frozenset = ENGINE_OPS) -> "FaultPlan | None":
        """Parse ``TONY_SERVE_FAULTS`` (a JSON fault object or list)
        into the plan addressed to ``replica`` — None when the variable
        is unset/empty or no fault targets this replica. ``ops``
        selects the consumer's kind (engine ops by default — the
        gateway-side stub arms ``transport_from_env``); entries of the
        other kind are validated but not armed here. Invalid specs
        raise loudly: a chaos run with a silently ignored typo'd fault
        would assert against a fault-free gateway."""
        spec = (os.environ if env is None else env).get(ENV_VAR, "").strip()
        if not spec:
            return None
        try:
            docs = json.loads(spec)
        except json.JSONDecodeError as e:
            raise ValueError(f"{ENV_VAR} is not valid JSON: {e}") from None
        if isinstance(docs, dict):
            docs = [docs]
        faults = []
        for d in docs:
            if not isinstance(d, dict):
                raise ValueError(f"{ENV_VAR} entries must be objects: {d!r}")
            f = Fault(**d)
            if f.op not in ops:
                continue
            if f.replica is None or replica is None or f.replica == replica:
                faults.append(f)
        return cls(faults) if faults else None

    @classmethod
    def transport_from_env(cls, replica: int | None = None,
                           env=None) -> "FaultPlan | None":
        """The transport side's arming point: transport faults
        addressed to ``replica``'s stub."""
        return cls.from_env(replica, env=env, ops=TRANSPORT_OPS)

    @classmethod
    def fail_at(cls, dispatch: int, times: int = 1) -> "FaultPlan":
        return cls([Fault("fail", dispatch=dispatch, times=times)])

    @classmethod
    def wedge_at(cls, dispatch: int, seconds: float,
                 times: int = 1) -> "FaultPlan":
        return cls([Fault("wedge", dispatch=dispatch, seconds=seconds,
                          times=times)])

    @classmethod
    def fail_request(cls, request, times: int = 1) -> "FaultPlan":
        return cls([Fault("fail", request=request, times=times)])

    # --------------------------------------------------------- firing

    def _fire(self, fault: Fault, what: str) -> None:
        if fault.times > 0:
            fault.times -= 1
        self.fired += 1
        if fault.op in ("wedge", "delay"):
            log.warning("fault injection: %s %.2fs at %s",
                        "wedging" if fault.op == "wedge" else "delaying",
                        fault.seconds, what)
            time.sleep(fault.seconds)
            return
        log.warning("fault injection: %s at %s", fault.op, what)
        if fault.op == "refuse":
            raise ConnectionRefusedError(
                f"injected connection refusal at {what}")
        if fault.op == "disconnect":
            raise ConnectionResetError(f"injected disconnect at {what}")
        if fault.op in ("blackhole", "half_open"):
            # the realistic shape: nothing arrives until the caller's
            # read timeout — the optional seconds model that wait
            # without making tests pay a real socket timeout
            if fault.seconds > 0:
                time.sleep(fault.seconds)
            raise TimeoutError(f"injected {fault.op} at {what}")
        raise InjectedFault(f"injected failure at {what}")

    def on_dispatch(self) -> None:
        """Hook at the top of ``Server.step()``; counts scheduler
        dispatches and fires any armed dispatch-triggered fault."""
        self.n_dispatches += 1
        for f in self.faults:
            if f.times == 0 or f.dispatch is None:
                continue
            if self.n_dispatches >= f.dispatch:
                self._fire(f, f"dispatch {self.n_dispatches}")

    def on_admit(self, request_id) -> None:
        """Hook before a request's prefill admission dispatch."""
        for f in self.faults:
            if f.times == 0 or f.request is None:
                continue
            if f.request == request_id:
                self._fire(f, f"admit of request {request_id!r}")

    # ------------------------------------------------------- transport

    def on_call(self, what: str, request=None) -> None:
        """Hook before the remote stub issues one HTTP call (submit /
        stream connect / heartbeat / reset / drain — all count).
        Fires call-count-triggered refuse/blackhole/delay faults, and
        request-triggered ones when ``request`` names the engine id
        the call is about."""
        self.n_calls += 1
        for f in self.faults:
            if f.times == 0 or f.op not in _CALL_OPS:
                continue
            if f.call is not None and self.n_calls >= f.call:
                self._fire(f, f"transport call {self.n_calls} ({what})")
            elif f.request is not None and request is not None \
                    and f.request == request:
                self._fire(f, f"transport call for request {request!r} "
                              f"({what})")

    def on_stream(self, what: str, request=None) -> None:
        """Hook per stream READ (one NDJSON line) on the remote stub:
        disconnect-mid-stream and half-open land here — after the
        connection succeeded, while the body flows. Shares the call
        counter's trigger numbering (``call`` = the connect's number,
        so "disconnect the stream call 3 opened" composes)."""
        for f in self.faults:
            if f.times == 0 or f.op not in _STREAM_OPS:
                continue
            if f.call is not None and self.n_calls >= f.call:
                self._fire(f, f"stream read ({what})")
            elif f.request is not None and request is not None \
                    and f.request == request:
                self._fire(f, f"stream read for request {request!r} "
                              f"({what})")
