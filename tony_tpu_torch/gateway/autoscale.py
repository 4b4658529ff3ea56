"""Elastic autoscaling: close the loop between the gateway and the
TonY control plane.

TonY's defining move is a control plane that ACQUIRES AND RELEASES
resources to match the job (the AM asks YARN for containers as roles
need them, returns them when tasks finish). The serving gateway had
every sensor that loop needs — queue depth and oldest-wait age on the
new ``/stats`` queue block, shed rates, TTFT SLO burn in the lifetime
histograms, ``kv_pages`` pressure — and both actuation primitives
(``Gateway.add_replica`` rides the circuit breaker's probe admission,
``Gateway.remove_replica`` rides the zero-loss drain — which
MIGRATES the victim's in-flight sessions to the survivors
mid-stream instead of decoding them to completion, so a scale-down is
also a defragmentation: the fleet's live work packs onto the replicas
that remain, token-exact, and the victim's drain time is bounded by
freeze cost rather than its longest remaining generation), but
nothing connected them. ``AutoScaler`` is that connection:

- a control loop samples ``Gateway.scale_signals()`` every
  ``interval_s`` and classifies the fleet as PRESSURED (queue depth
  per routable replica, oldest queued wait, capacity sheds since the
  last tick, TTFT SLO burn, KV-page exhaustion), IDLE (empty queues,
  near-empty slots, no recent enqueues), or neither;
- hysteresis: a scale-up needs ``up_stable`` consecutive pressured
  ticks, a scale-down ``down_stable`` consecutive idle ticks, and
  each action arms its own cooldown — the loop structurally cannot
  flap (the up condition is pressure, the down condition is complete
  idleness; no signal satisfies both);
- min/max bounds; scale-up capacity comes from a ``backend``:
  ``ThreadBackend`` builds another in-process ``serve.Server`` (the
  tests/CPU/dev story — replicas are threads sharing weights), and
  ``ProvisionerBackend`` acquires hosts through a
  provisioner first (the production shape: one
  ``Provisioner`` per dynamic replica, deprovisioned at scale-down).

Every decision — action, reason, the signals it read — lands in the
in-memory ring behind ``/stats``'s ``scaler`` block and, with history
on, in ``metrics/scaling.jsonl`` next to ``requests.jsonl`` (the
portal renders both), so "why did the fleet grow at 14:02" is
answerable from the job record.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

log = logging.getLogger(__name__)


class ScaleError(RuntimeError):
    """A backend failed to produce or release capacity."""


class ThreadBackend:
    """In-process replica capacity: ``create()`` builds another
    ``serve.Server`` via the factory (weights shared — a new replica
    costs one KV cache, not a checkpoint load). The tests/CPU/dev
    backend; also the right one for a single host with spare
    cards. ``destroy`` drops the reference — the engine was already
    released by ``remove_replica``."""

    def __init__(self, server_factory, label: str = "thread"):
        self._factory = server_factory
        self._label = label  # /stats backend name ("remote-agent"
        #                      when the factory launches agent stubs)
        self.created = 0
        self.destroyed = 0

    def create(self):
        server = self._factory()
        self.created += 1
        return server

    def destroy(self, server) -> None:
        # remote stubs: a destroyed replica's agent must not outlive
        # it (remove_replica already closed a RETIRING one; a server
        # that never joined — failed probe admission — is closed here)
        from tony_tpu_torch.gateway.remote import close_server

        close_server(server, "thread-backend destroy")
        self.destroyed += 1

    def describe(self) -> str:
        return self._label


class ProvisionerBackend:
    """Slice-backed replica capacity: each ``create()`` acquires a
    slice of hosts through a fresh provisioner
    (``provisioner_factory(slot)``, anything with ``provision()`` and
    ``deprovision()``) and hands its host list to ``server_factory(hosts)``;
    ``destroy()`` deprovisions the slice. Failures surface as
    ``ScaleError`` (a failed acquisition must cost a logged decision
    and a cooldown, never a crashed control loop); a provision that
    succeeded but whose server construction failed is deprovisioned
    on the spot — no leaked slices.

    The REMOTE mode (the closed TonY loop): pass
    ``cli.gateway.remote_server_factory(args)`` as the server factory
    (``lambda hosts: rmake(index, hosts=hosts)``) and the acquired
    slice's hosts get a replica AGENT (``cli/replica.py``) with a
    ``RemoteServer`` stub returned — the engine runs on the slice,
    and ``destroy()`` closing the stub then deprovisioning the slice
    is exactly "the dead host's capacity goes back" with nothing
    leaked."""

    def __init__(self, provisioner_factory, server_factory):
        self._provisioner_factory = provisioner_factory
        self._server_factory = server_factory
        self._slices: dict[int, object] = {}  # id(server) -> Provisioner
        self._slot = 0

    def create(self):
        slot = self._slot
        self._slot += 1
        prov = self._provisioner_factory(slot)
        try:
            hosts = prov.provision()
        except Exception as e:
            raise ScaleError(f"slice provision failed: {e}") from e
        try:
            server = self._server_factory(hosts)
        except Exception as e:
            try:
                prov.deprovision()
            except Exception:  # noqa: BLE001 — best-effort teardown,
                log.exception("deprovision after failed server build")
            raise ScaleError(f"server build on {hosts} failed: {e}") from e
        self._slices[id(server)] = prov
        return server

    def destroy(self, server) -> None:
        # remote stubs first: stop heartbeating (and reap a launched
        # agent) BEFORE the slice under it is deleted — the lease
        # machinery must not spend a deprovision window counting
        # connect errors against a host that is going away on purpose
        from tony_tpu_torch.gateway.remote import close_server

        close_server(server, "provisioner-backend destroy")
        prov = self._slices.pop(id(server), None)
        if prov is not None:
            try:
                prov.deprovision()
            except Exception as e:  # noqa: BLE001 — teardown trouble is
                # a logged decision, not a dead control loop
                raise ScaleError(f"slice deprovision failed: {e}") from e

    def describe(self) -> str:
        return "provisioner"


class AutoScaler:
    """The gateway's elasticity control loop. Construct with a started
    ``Gateway`` and a backend, then ``start()``; ``stop()`` is
    idempotent and also called by ``Gateway.drain()``.

    Knobs (all per-loop-tick unless noted):

    - ``min_replicas`` / ``max_replicas``: hard fleet bounds (live
      replicas, i.e. not retired/retiring).
    - ``interval_s``: tick period.
    - ``up_queue_depth``: queued tickets per ROUTABLE replica that
      count as pressure.
    - ``up_wait_s``: oldest queued ticket age that counts as pressure.
    - ``ttft_slo_s`` + ``slo_burn``: pressure when more than
      ``slo_burn`` of the requests completed since the last tick
      exceeded the TTFT SLO (computed from deltas of the lifetime
      histogram — needs ``min_slo_sample`` completions per tick to
      vote, so a trickle can't trigger on one slow request).
    - ``kv_used_frac``: pressure when the paged-KV pool is fuller
      than this fleet-wide (0 disables; unpaged fleets never vote).
    - ``up_stable`` / ``down_stable``: consecutive pressured / idle
      ticks (hysteresis) before acting.
    - ``cooldown_up_s`` / ``cooldown_down_s``: lockout after each
      action (shared: any action resets both directions' streaks).
    - ``idle_slot_frac``: the fleet counts as idle only when active
      slots are at or below this fraction (and queues are empty and
      nothing was enqueued within the tick).
    """

    def __init__(self, gateway, backend, *, min_replicas: int = 1,
                 max_replicas: int = 4, interval_s: float = 1.0,
                 up_queue_depth: float = 4.0, up_wait_s: float = 1.0,
                 ttft_slo_s: float = 0.0, slo_burn: float = 0.1,
                 min_slo_sample: int = 5, kv_used_frac: float = 0.95,
                 up_stable: int = 2, down_stable: int = 5,
                 cooldown_up_s: float = 5.0, cooldown_down_s: float = 15.0,
                 idle_slot_frac: float = 0.25,
                 drain_timeout_s: float = 120.0,
                 decisions_kept: int = 64):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) < min_replicas "
                f"({min_replicas})")
        self.gateway = gateway
        self.backend = backend
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.interval_s = max(0.01, interval_s)
        self.up_queue_depth = up_queue_depth
        self.up_wait_s = up_wait_s
        self.ttft_slo_s = ttft_slo_s
        self.slo_burn = slo_burn
        self.min_slo_sample = max(1, min_slo_sample)
        self.kv_used_frac = kv_used_frac
        self.up_stable = max(1, up_stable)
        self.down_stable = max(1, down_stable)
        self.cooldown_up_s = cooldown_up_s
        self.cooldown_down_s = cooldown_down_s
        self.idle_slot_frac = idle_slot_frac
        self.drain_timeout_s = drain_timeout_s
        # decision state
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown_until = 0.0
        self._last_shed = 0
        self._last_ttft = (0, 0)  # (count, over-slo) cumulative
        self._last_enq: dict[int, int] = {}  # replica -> enqueued seen
        self.scale_ups = 0
        self.scale_downs = 0
        self.errors = 0
        self.ticks = 0
        self.decisions: deque[dict] = deque(maxlen=max(1, decisions_kept))
        self._servers: dict[int, object] = {}  # replica idx -> server
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()  # guards status vs the loop
        gateway.scaler = self  # surface on /stats; stopped by drain()

    # -------------------------------------------------------- lifecycle

    def start(self) -> "AutoScaler":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop,
                                        name="gateway-autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float | None = None) -> None:
        """Idempotent; joins the loop thread. A scale action in flight
        (a slice provision, a drain) finishes first — the loop checks
        the stop flag between ticks, not inside an action."""
        self._stop_evt.set()
        t = self._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout if timeout is not None
                   else self.drain_timeout_s + 10 * self.interval_s + 30)

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the control loop must
                # survive anything: a broken tick is a logged error
                # plus a missed beat, never a dead autoscaler
                self.errors += 1
                log.exception("autoscaler tick failed")

    # --------------------------------------------------------- decisions

    def tick(self) -> str | None:
        """One control iteration (public for tests: drive the loop by
        hand with a fake clock-free cadence). Returns the action taken
        ("up"/"down") or None."""
        sig = self.gateway.scale_signals()
        now = sig["now"]
        self.ticks += 1
        action, reasons = self.decide(sig, now)
        if action == "up":
            self._scale_up(sig, reasons)
        elif action == "down":
            self._scale_down(sig, reasons)
        return action

    def decide(self, sig: dict, now: float) -> tuple[str | None, list]:
        """Pure decision half (unit-testable): classify the tick,
        advance the hysteresis streaks, and return the action once a
        streak crosses its threshold outside the cooldown."""
        pressure = self._pressure_reasons(sig)
        idle = not pressure and self._is_idle(sig)
        if pressure:
            self._up_streak += 1
            self._down_streak = 0
        elif idle:
            self._down_streak += 1
            self._up_streak = 0
        else:
            # neither pressured nor fully idle: decay both streaks —
            # hysteresis counts CONSECUTIVE ticks only
            self._up_streak = 0
            self._down_streak = 0
        live = sig["replicas_live"]
        if now < self._cooldown_until:
            return None, pressure
        if live < self.min_replicas:
            # below the configured floor (boot under-provisioned, or a
            # prior scale-up failed): grow regardless of pressure —
            # paced by the cooldown so a broken backend isn't
            # hot-looped
            return "up", [f"below floor ({live} < min "
                          f"{self.min_replicas})"]
        if pressure and self._up_streak >= self.up_stable \
                and live < self.max_replicas:
            return "up", pressure
        if idle and self._down_streak >= self.down_stable \
                and live > self.min_replicas:
            return "down", ["idle"]
        return None, pressure

    def _pressure_reasons(self, sig: dict) -> list[str]:
        reasons = []
        routable = max(1, sig["replicas_routable"])
        per_rep = sig["depth"] / routable
        if per_rep >= self.up_queue_depth:
            reasons.append(f"queue_depth {sig['depth']} "
                           f"({per_rep:.1f}/replica)")
        if sig["oldest_wait_s"] >= self.up_wait_s:
            reasons.append(f"oldest_wait {sig['oldest_wait_s']:.2f}s")
        shed = sig["shed_capacity_total"]
        if shed > self._last_shed:
            reasons.append(f"sheds +{shed - self._last_shed}")
        self._last_shed = shed
        burn = self._ttft_burn(sig)
        if burn is not None and burn > self.slo_burn:
            reasons.append(f"ttft_slo_burn {burn:.2f}")
        if self.kv_used_frac > 0 and sig["kv_pages_total"] > 0:
            used = 1.0 - sig["kv_pages_free"] / sig["kv_pages_total"]
            if used >= self.kv_used_frac:
                reasons.append(f"kv_pages {used:.0%} used")
        return reasons

    def _ttft_burn(self, sig: dict) -> float | None:
        """Fraction of requests completed SINCE THE LAST TICK whose
        TTFT exceeded the SLO, from deltas of the lifetime histogram
        (bucket edges, so the SLO is effectively rounded up to the
        next edge). None = disabled or too small a sample to vote."""
        if self.ttft_slo_s <= 0:
            return None
        from tony_tpu_torch.obs.prom import hist_over_edge

        # SLO-rounds-up-to-the-next-edge semantics live in ONE place
        # (obs/prom.hist_over_edge), shared with the alert bus's
        # ttft_slo_burn rule — the two surfaces must never disagree
        over, total = hist_over_edge(sig["ttft_hist"], self.ttft_slo_s)
        d_total = total - self._last_ttft[0]
        d_over = over - self._last_ttft[1]
        self._last_ttft = (total, over)
        if d_total < self.min_slo_sample:
            return None
        return d_over / d_total

    def _is_idle(self, sig: dict) -> bool:
        if sig["depth"] > 0 or sig["oldest_wait_s"] > 0:
            return False
        slots = sig["slots"]
        if slots and sig["active_slots"] > self.idle_slot_frac * slots:
            return False
        # no enqueues since the last tick: compare per-replica
        # lifetime enqueue counters (rate windows are too coarse for
        # sub-window intervals)
        idle = True
        for r in self.gateway.live_replicas:
            if r.enqueued > self._last_enq.get(r.index, 0):
                idle = False
            self._last_enq[r.index] = r.enqueued
        return idle

    # ----------------------------------------------------------- actions

    def _scale_up(self, sig: dict, reasons: list) -> None:
        t0 = time.monotonic()
        try:
            server = self.backend.create()
        except Exception as e:  # noqa: BLE001 — a failed acquisition
            # is a recorded decision + cooldown (do NOT hot-loop a
            # broken backend), never a dead control loop
            self.errors += 1
            log.exception("scale-up create failed")
            self._record("up_failed", sig, reasons, error=str(e))
            self._after_action(up=True)
            return
        try:
            index = self.gateway.add_replica(server, probe=True)
        except Exception as e:  # noqa: BLE001 — e.g. the gateway
            # closed while a slow slice provision was in flight: the
            # capacity we just acquired MUST go back (a billed host
            # slice must never outlive the failed join)
            self.errors += 1
            log.exception("scale-up join failed; releasing capacity")
            try:
                self.backend.destroy(server)
            except Exception:  # noqa: BLE001 — best-effort teardown
                log.exception("release after failed join also failed")
            self._record("up_failed", sig, reasons, error=str(e))
            self._after_action(up=True)
            return
        with self._lock:
            self._servers[index] = server
        self.scale_ups += 1
        self._record("up", sig, reasons, replica=index,
                     took_s=round(time.monotonic() - t0, 3))
        self._after_action(up=True)
        log.warning("autoscaler: scale-up -> replica %d (probe pending; "
                    "reasons: %s)", index, "; ".join(reasons))

    def _scale_down(self, sig: dict, reasons: list) -> None:
        victim = self._pick_victim()
        if victim is None:
            return
        t0 = time.monotonic()
        try:
            ok = self.gateway.remove_replica(victim.index,
                                             timeout=self.drain_timeout_s)
        except ValueError as e:  # last-live race: bounds moved under us
            self._record("down_failed", sig, reasons, error=str(e))
            self._after_action(up=False)
            return
        if not ok:
            # still draining past the deadline: it is out of routing
            # and will finish; pick it up again on a later tick
            self.errors += 1
            self._record("down_timeout", sig, reasons,
                         replica=victim.index)
            self._after_action(up=False)
            return
        with self._lock:
            server = self._servers.pop(victim.index, None)
        try:
            self.backend.destroy(server)
        except Exception as e:  # noqa: BLE001 — the replica is gone
            # either way; a teardown hiccup is a logged decision
            self.errors += 1
            log.exception("scale-down backend destroy failed")
            self._record("destroy_failed", sig, reasons, error=str(e))
        self.scale_downs += 1
        self._record("down", sig, ["idle"], replica=victim.index,
                     took_s=round(time.monotonic() - t0, 3))
        self._after_action(up=False)
        log.warning("autoscaler: scale-down retired replica %d "
                    "(zero-loss drain)", victim.index)

    def _pick_victim(self):
        """Scale-down victim order: a quarantined/broken replica first
        (it serves nothing — retiring it frees real capacity at zero
        traffic cost), then the youngest dynamically-added one, then
        the youngest of all — never below the floor the caller already
        checked."""
        live = self.gateway.live_replicas
        if len(live) <= self.min_replicas:
            return None
        from tony_tpu_torch.gateway.core import HEALTHY

        dead = [r for r in live if r.state != HEALTHY]
        if dead:
            return dead[-1]
        spawned = [r for r in live if r.spawned]
        return (spawned or live)[-1]

    def _after_action(self, up: bool) -> None:
        self._cooldown_until = time.monotonic() + \
            (self.cooldown_up_s if up else self.cooldown_down_s)
        self._up_streak = 0
        self._down_streak = 0

    # ------------------------------------------------------ observability

    def _record(self, action: str, sig: dict, reasons: list,
                **extra) -> None:
        row = {
            "t": round(time.time(), 3),
            "action": action,
            "reasons": list(reasons),
            "replicas_live": sig["replicas_live"],
            "queue_depth": sig["depth"],
            "oldest_wait_s": sig["oldest_wait_s"],
            **extra,
        }
        with self._lock:
            self.decisions.append(row)
        history = getattr(self.gateway, "history", None)
        if history is not None:
            try:
                history.record_scaling(row)
            except Exception:  # noqa: BLE001 — same contract as every
                # other history write: never let a disk hiccup near
                # the serving path
                log.exception("history scaling write failed")

    def status(self) -> dict:
        """The /stats ``scaler`` block."""
        with self._lock:
            decisions = list(self.decisions)[-8:]
        return {
            "enabled": True,
            "backend": self.backend.describe()
            if hasattr(self.backend, "describe") else
            type(self.backend).__name__,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "interval_s": self.interval_s,
            "replicas_live": len(self.gateway.live_replicas),
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "errors": self.errors,
            "ticks": self.ticks,
            "up_streak": self._up_streak,
            "down_streak": self._down_streak,
            "cooldown_s": round(
                max(0.0, self._cooldown_until - time.monotonic()), 3),
            "last_decisions": decisions,
        }
