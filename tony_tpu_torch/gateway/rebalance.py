"""Pressure-driven session rebalancing: close the loop between the
fleet's occupancy sensors and live migration.

PR 18 made in-flight sessions MOVABLE (``Gateway.migrate_session``
freezes a decode slot mid-stream and re-admits it elsewhere,
token-exact); retirement and failover already use that machinery, but
only topology CHANGES triggered it. A fleet whose topology is stable
can still be badly packed: a connection storm lands on whichever
replicas were routable at the time, a scale-up adds a cold empty
replica that only NEW sessions discover, and long streams pin their
slots for minutes. The result is one replica decoding at full batch
while its neighbour idles — the exact shape TonY's control plane
exists to fix (acquire/release resources to MATCH the job, not the
job's arrival order).

``Rebalancer`` is the missing loop, built like ``AutoScaler`` (one
consistent signals read per tick, pure ``decide()``, streak
hysteresis, per-direction cooldowns) but actuating migration instead
of membership:

- every ``interval_s`` it reads ``Gateway.rebalance_signals()`` — one
  consistent per-replica view of slot occupancy, queue depth, and the
  in-flight ticket set;
- the fleet counts as SKEWED when the hottest replica's occupancy
  fraction exceeds the coldest's by ``skew_frac`` AND the hot replica
  holds at least ``min_sessions`` more active sessions AND the cold
  one has a free slot (moving onto a full replica is churn, not
  balance);
- hysteresis: ``stable`` consecutive skewed ticks before acting, then
  a ``cooldown_s`` lockout (``fail_cooldown_s`` after a move that
  found nothing to migrate — a broken condition must not hot-loop);
- the victim is chosen by PREFIX HEAT: each of the hot replica's
  in-flight prompts is scored with the cold replica's
  ``prefix_match_len`` probe (local radix walk, or the heartbeat
  summary for remote stubs), and the session the cold side already
  holds pages for wins — its migration ships the least KV, and with
  delta trimming (this PR) possibly only its suffix. Ties fall to the
  session with the MOST remaining work, so one move transfers the
  most future load;
- the move itself is ``gateway.migrate_session(rid)`` — the ordinary
  routing stack places it, so prefix affinity and least-outstanding
  tie-breaks steer it toward the cold replica without this loop ever
  naming a destination (routing policy stays in ONE place).

Every decision — moved or skipped, with the skew it saw — lands in
the ring behind /stats ``rebalance``, in ``tony_rebalance_*``
metrics, and (with history on) in ``metrics/rebalance.jsonl``, so
"why did request 17 jump replicas at 14:02" is answerable from the
job record.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

log = logging.getLogger(__name__)


class Rebalancer:
    """The gateway's session-packing control loop. Construct with a
    started ``Gateway``, then ``start()``; ``stop()`` is idempotent
    and also called by ``Gateway.drain()``.

    Knobs:

    - ``interval_s``: tick period.
    - ``skew_frac``: minimum (hot - cold) occupancy-fraction gap that
      counts as skew (0.5 = hot replica 50 points fuller).
    - ``min_sessions``: the hot replica must hold at least this many
      more ACTIVE sessions than the cold one (fraction gaps on tiny
      batch sizes are noise).
    - ``stable``: consecutive skewed ticks before a move (hysteresis).
    - ``cooldown_s`` / ``fail_cooldown_s``: lockout after a successful
      / failed move.
    - ``max_moves``: sessions migrated per acting tick (default 1 —
      one move changes the signals; re-deciding on fresh ones beats
      batch-moving on stale ones).
    """

    def __init__(self, gateway, *, interval_s: float = 1.0,
                 skew_frac: float = 0.5, min_sessions: int = 2,
                 stable: int = 2, cooldown_s: float = 5.0,
                 fail_cooldown_s: float = 10.0, max_moves: int = 1,
                 decisions_kept: int = 64):
        if not 0.0 < skew_frac <= 1.0:
            raise ValueError(f"skew_frac must be in (0, 1], "
                             f"got {skew_frac}")
        self.gateway = gateway
        self.interval_s = max(0.01, interval_s)
        self.skew_frac = skew_frac
        self.min_sessions = max(1, min_sessions)
        self.stable = max(1, stable)
        self.cooldown_s = cooldown_s
        self.fail_cooldown_s = fail_cooldown_s
        self.max_moves = max(1, max_moves)
        # decision state
        self._streak = 0
        self._cooldown_until = 0.0
        self.moves = 0
        self.move_failures = 0
        self.errors = 0
        self.ticks = 0
        self.decisions: deque[dict] = deque(maxlen=max(1, decisions_kept))
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()  # guards status vs the loop
        gateway.rebalancer = self  # surface on /stats; stopped by drain()

    # -------------------------------------------------------- lifecycle

    def start(self) -> "Rebalancer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop,
                                        name="gateway-rebalancer",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float | None = None) -> None:
        """Idempotent; joins the loop thread. A migration in flight
        finishes first — the loop checks the stop flag between ticks,
        not inside an action."""
        self._stop_evt.set()
        t = self._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout if timeout is not None
                   else 10 * self.interval_s + 30)

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the control loop must
                # survive anything: a broken tick is a logged error
                # plus a missed beat, never a dead rebalancer
                self.errors += 1
                log.exception("rebalancer tick failed")

    # --------------------------------------------------------- decisions

    def tick(self) -> int:
        """One control iteration (public for tests: drive the loop by
        hand). Returns the number of sessions moved this tick."""
        sig = self.gateway.rebalance_signals()
        self.ticks += 1
        plan, reasons = self.decide(sig, sig["now"])
        if plan is None:
            return 0
        return self._execute(plan, sig, reasons)

    def decide(self, sig: dict, now: float) -> tuple[dict | None, list]:
        """Pure decision half (unit-testable): classify the tick as
        skewed or not, advance the hysteresis streak, and return the
        (hot, cold) pair once the streak crosses ``stable`` outside
        the cooldown. The pair is a PLAN, not a promise — victim
        choice and the move itself happen in ``_execute``."""
        skew = self._skew(sig)
        if skew is None:
            self._streak = 0
            return None, []
        hot, cold, gap = skew
        self._streak += 1
        reasons = [f"skew {gap:.2f} (replica {hot['index']} "
                   f"{hot['active']}/{hot['slots']} vs replica "
                   f"{cold['index']} {cold['active']}/{cold['slots']})"]
        if now < self._cooldown_until or self._streak < self.stable:
            return None, reasons
        return {"hot": hot, "cold": cold, "gap": gap}, reasons

    def _skew(self, sig: dict) -> tuple[dict, dict, float] | None:
        """The skew classifier: (hot row, cold row, fraction gap) when
        the fleet is imbalanced enough to act on, else None."""
        rows = [r for r in sig["replicas"] if r["slots"] > 0]
        if len(rows) < 2:
            return None
        hot = max(rows, key=lambda r: (r["active"] / r["slots"],
                                       r["active"]))
        cold = min(rows, key=lambda r: (r["active"] / r["slots"],
                                        r["active"]))
        if hot["index"] == cold["index"]:
            return None
        gap = hot["active"] / hot["slots"] - cold["active"] / cold["slots"]
        if gap < self.skew_frac:
            return None
        if hot["active"] < cold["active"] + self.min_sessions:
            return None
        if cold["active"] >= cold["slots"]:
            # nowhere for the session to land: routing would put it
            # right back (or worse, on the hot replica's queue)
            return None
        if not hot["tickets"]:
            # active slots but no gateway tickets: sessions the
            # gateway cannot name (mid-admission) — wait them out
            return None
        return hot, cold, gap

    def _victims(self, plan: dict) -> list:
        """Rank the hot replica's in-flight sessions by how cheaply
        the COLD side could adopt them: longest cached prefix first
        (those migrations ship the least KV — with delta trimming,
        only the suffix), most remaining work as the tie-break (one
        move should transfer the most future load)."""
        cold = next((r for r in self.gateway.live_replicas
                     if r.index == plan["cold"]["index"]), None)
        probe = getattr(cold.server, "prefix_match_len", None) \
            if cold is not None and cold.server is not None else None
        scored = []
        for row in plan["hot"]["tickets"]:
            heat = 0
            if probe is not None and row["prompt"]:
                try:
                    heat = int(probe(row["prompt"]))
                except Exception:  # noqa: BLE001 — a failed probe
                    # costs a 0 score, never a dead tick
                    log.exception("rebalance prefix probe failed")
            scored.append((heat, row["remaining"], row["rid"]))
        scored.sort(key=lambda s: (-s[0], -s[1]))
        return [rid for _, _, rid in scored]

    # ----------------------------------------------------------- actions

    def _execute(self, plan: dict, sig: dict, reasons: list) -> int:
        moved = 0
        t0 = time.monotonic()
        for rid in self._victims(plan):
            try:
                ok = self.gateway.migrate_session(rid)
            except Exception as e:  # noqa: BLE001 — a failed move is a
                # recorded decision + cooldown, never a dead loop
                self.errors += 1
                log.exception("rebalance migration failed")
                self._record("move_failed", sig, reasons, rid=rid,
                             error=str(e))
                self._after_action(ok=False)
                return moved
            if ok:
                moved += 1
                self.moves += 1
                self._record("move", sig, reasons, rid=rid,
                             from_replica=plan["hot"]["index"],
                             gap=round(plan["gap"], 3),
                             took_s=round(time.monotonic() - t0, 3))
                log.warning("rebalancer: migrated request %s off "
                            "replica %d (%s)", rid,
                            plan["hot"]["index"], "; ".join(reasons))
                if moved >= self.max_moves:
                    break
            # not ok: the session finished or left its slot between
            # the signals read and the freeze — try the next victim
        if moved == 0:
            self.move_failures += 1
            self._record("no_victim", sig, reasons)
        self._after_action(ok=moved > 0)
        return moved

    def _after_action(self, ok: bool) -> None:
        self._cooldown_until = time.monotonic() + \
            (self.cooldown_s if ok else self.fail_cooldown_s)
        self._streak = 0

    # ------------------------------------------------------ observability

    def _record(self, action: str, sig: dict, reasons: list,
                **extra) -> None:
        row = {
            "t": round(time.time(), 3),
            "action": action,
            "reasons": list(reasons),
            "occupancy": [[r["index"], r["active"], r["slots"]]
                          for r in sig["replicas"]],
            **extra,
        }
        with self._lock:
            self.decisions.append(row)
        history = getattr(self.gateway, "history", None)
        if history is not None:
            try:
                history.record_rebalance(row)
            except Exception:  # noqa: BLE001 — same contract as every
                # other history write: never let a disk hiccup near
                # the serving path
                log.exception("history rebalance write failed")

    def status(self) -> dict:
        """The /stats ``rebalance`` block."""
        with self._lock:
            decisions = list(self.decisions)[-8:]
        return {
            "enabled": True,
            "interval_s": self.interval_s,
            "skew_frac": self.skew_frac,
            "min_sessions": self.min_sessions,
            "moves": self.moves,
            "move_failures": self.move_failures,
            "errors": self.errors,
            "ticks": self.ticks,
            "streak": self._streak,
            "cooldown_s": round(
                max(0.0, self._cooldown_until - time.monotonic()), 3),
            "last_decisions": decisions,
        }
