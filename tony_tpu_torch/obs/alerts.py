"""Serving alert/event bus: a small rule engine over fleet signals.

The PyTorch port's copy of ``tony_tpu/obs/alerts.py``.

The TonY portal answers "what happened to my job" after the fact; an
operator running a serving fleet needs the same story LIVE — not a
wall of gauges, but a short list of named conditions that are
currently true, each with a fire event when it started and a resolve
event when it stopped. This module is that list:

- ``Rule``: a named predicate over the gateway's consistent signal
  snapshot (``Gateway.alert_signals()`` — the same read the
  autoscaler's ``scale_signals()`` builds on, so an alert and a scale
  decision can never disagree about what they saw). Stateful rules
  (SLO burn needs histogram deltas, flap detection needs a failure
  window, goodput collapse needs a trailing baseline) keep their state
  inside the rule object — the bus itself is stateless per rule
  beyond active/pending bookkeeping.
- ``AlertBus``: evaluates every rule per tick and emits STRUCTURED,
  DEDUPLICATED transitions: one ``firing`` event when a rule's
  condition has held for ``fire_after`` consecutive ticks, one
  ``resolved`` event after ``resolve_after`` consecutive clear ticks —
  never a re-fire while active, never a flap on a single noisy tick.
  Events carry wall-clock time, severity, a human message, and the
  signal detail the rule matched on; they land in history
  ``metrics/alerts.jsonl`` (next to requests/scaling, portal-rendered),
  the ``/stats`` ``alerts`` block (active + recent), and ``/metrics``
  (``tony_alerts_*``).

Default rules (thresholds overridable via ``default_rules()``):

| rule                  | fires when                                   |
| --------------------- | -------------------------------------------- |
| ``queue_aging``       | oldest queued wait exceeds ``queue_wait_s``  |
| ``kv_pages_pressure`` | free-after-reservation KV pages under        |
|                       | ``kv_free_frac`` of the pool while work is   |
|                       | live/queued                                  |
| ``kv_host_thrash``    | host-tier page-in bytes per tick over        |
|                       | ``host_thrash_bytes`` WHILE the pool is also |
|                       | pressured (spill/restore churn: the HBM pool |
|                       | is undersized for the prefix working set)    |
| ``ttft_slo_burn``     | >``burn_frac`` of a tick's completions over  |
|                       | ``ttft_slo_s`` (histogram delta; off at 0)   |
| ``breaker_flap``      | >= ``flap_failures`` replica failures inside |
|                       | ``flap_window_s`` (states alone never fire — |
|                       | probe admission is the routine scale-up path)|
| ``goodput_collapse``  | per-tick useful fraction under               |
|                       | ``collapse_frac`` x its trailing baseline    |
|                       | while tokens are flowing                     |
| ``gateway_recovery``  | the gateway restarted through ``--recover``  |
|                       | within the last ``recovery_recent_s``        |
|                       | (repeat firings = a crash loop)              |
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class AlertEvent:
    """One transition: ``state`` is "firing" or "resolved".
    ``t_wall`` is epoch seconds (jsonl rows must survive process
    restarts, so no monotonic here)."""

    alert: str
    severity: str
    state: str
    message: str
    t_wall: float
    detail: dict = field(default_factory=dict)

    def to_row(self) -> dict:
        return {
            "t": round(self.t_wall, 3),
            "alert": self.alert,
            "severity": self.severity,
            "state": self.state,
            "message": self.message,
            **{f"detail_{k}": v for k, v in self.detail.items()},
        }


class Rule:
    """Base rule: subclass (or pass ``check``) to implement
    ``evaluate(signals) -> dict | None`` — a detail dict means the
    condition holds this tick, None means it does not. ``fire_after``
    / ``resolve_after`` are the bus-side debounce (consecutive
    ticks)."""

    def __init__(self, name: str, severity: str = "warning",
                 check=None, fire_after: int = 1,
                 resolve_after: int = 2, message: str = ""):
        self.name = name
        self.severity = severity
        self._check = check
        self.fire_after = max(1, fire_after)
        self.resolve_after = max(1, resolve_after)
        self.message = message or name

    def evaluate(self, signals: dict):
        return self._check(signals) if self._check is not None else None


class QueueAgingRule(Rule):
    def __init__(self, queue_wait_s: float = 5.0, **kw):
        super().__init__("queue_aging",
                         message="admission queue is aging", **kw)
        self.queue_wait_s = queue_wait_s

    def evaluate(self, signals):
        wait = signals.get("oldest_wait_s", 0.0)
        if wait > self.queue_wait_s:
            return {"oldest_wait_s": wait,
                    "threshold_s": self.queue_wait_s,
                    "depth": signals.get("depth", 0)}
        return None


class KvPagesPressureRule(Rule):
    """Fires when the page pool's free-after-reservation headroom is
    under ``kv_free_frac`` of the pool WHILE work is live or queued —
    the reservation gate is about to start delaying admissions (the
    stay-pending backpressure). A full-but-idle pool (the
    prefix store pinning donated pages with nothing running) is
    residency, not pressure, and must resolve once load stops."""

    def __init__(self, kv_free_frac: float = 0.15, **kw):
        super().__init__("kv_pages_pressure",
                         message="KV page pool under pressure", **kw)
        self.kv_free_frac = kv_free_frac

    def evaluate(self, signals):
        total = signals.get("kv_pages_total", 0)
        if not total:
            return None
        busy = signals.get("active_slots", 0) > 0 \
            or signals.get("depth", 0) > 0
        headroom = (signals.get("kv_pages_free", 0)
                    - signals.get("kv_pages_reserved", 0)) / total
        if busy and headroom < self.kv_free_frac:
            return {"free_after_reserve_frac": round(headroom, 4),
                    "threshold_frac": self.kv_free_frac,
                    "kv_pages_total": total,
                    "kv_pages_free": signals.get("kv_pages_free", 0),
                    "kv_pages_reserved":
                        signals.get("kv_pages_reserved", 0)}
        return None


class KvHostThrashRule(Rule):
    """Host-tier RESTORE churn while the device pool is already under
    pressure: page-in bytes this tick over ``thrash_bytes`` AND the
    ``kv_pages_pressure`` condition simultaneously true. Each signal
    alone is healthy — page-ins are the tier paying for itself, and
    pressure is the reservation gate doing its job — but together they
    mean spill -> restore -> spill churn: the HBM pool is undersized
    for the live prefix working set (raise --kv-pages or lower
    --prefix-cache-mb). Reuses the pressure rule's own predicate (same
    thresholds) so this rule and that one can never disagree about
    what \"pressured\" means."""

    def __init__(self, thrash_bytes: float = float(1 << 20),
                 kv_free_frac: float = 0.15, **kw):
        super().__init__("kv_host_thrash",
                         message="host page tier thrashing", **kw)
        self.thrash_bytes = thrash_bytes
        self._pressure = KvPagesPressureRule(kv_free_frac=kv_free_frac)
        self._prev: float | None = None  # cumulative page-in bytes

    def evaluate(self, signals):
        total = signals.get("kv_host_page_in_bytes")
        prev, self._prev = self._prev, total
        if total is None or prev is None:
            return None
        delta = total - prev
        if delta < self.thrash_bytes:
            return None
        pressure = self._pressure.evaluate(signals)
        if pressure is None:
            return None
        return {"page_in_bytes_tick": delta,
                "threshold_bytes": self.thrash_bytes,
                "free_after_reserve_frac":
                    pressure["free_after_reserve_frac"]}


class TtftSloBurnRule(Rule):
    """Histogram-delta SLO burn, the autoscaler's signal as an alert:
    per tick, the fraction of NEW completions whose TTFT exceeded
    ``ttft_slo_s``, computed by the SAME ``obs/prom.hist_over_edge``
    helper the ``AutoScaler``'s burn signal uses (SLO rounded UP to
    the next bucket edge; one implementation, so an alert and a scale
    decision can never disagree about the same histogram).
    ``ttft_slo_s = 0`` disables the rule (it evaluates to None)."""

    def __init__(self, ttft_slo_s: float = 0.0, burn_frac: float = 0.10,
                 min_samples: int = 5, **kw):
        kw.setdefault("severity", "critical")
        super().__init__("ttft_slo_burn",
                         message="TTFT SLO burning", **kw)
        self.ttft_slo_s = ttft_slo_s
        self.burn_frac = burn_frac
        self.min_samples = max(1, min_samples)
        self._prev: tuple | None = None  # (over, total)

    def evaluate(self, signals):
        if self.ttft_slo_s <= 0:
            return None
        from tony_tpu_torch.obs.prom import hist_over_edge

        over, total = hist_over_edge(signals.get("ttft_hist") or {},
                                     self.ttft_slo_s)
        prev, self._prev = self._prev, (over, total)
        if prev is None:
            return None
        d_total = total - prev[1]
        if d_total < self.min_samples:
            return None
        burned = over - prev[0]
        frac = burned / d_total
        if frac > self.burn_frac:
            return {"burn_frac": round(frac, 4),
                    "threshold_frac": self.burn_frac,
                    "ttft_slo_s": self.ttft_slo_s,
                    "completions": d_total, "over_slo": burned}
        return None


class BreakerFlapRule(Rule):
    """Replica FAILURES clustering in time: the supervision story is
    working, but somebody should look at WHY it keeps having to.
    Deliberately counts only the failure counter, never breaker
    STATES: a broken/probing replica is also the routine scale-up
    admission path (``add_replica(probe=True)`` enters BROKEN and
    probes its way into routing), and a critical alert on every
    healthy elastic scale-up would train operators to ignore the
    rule. A replica that got broken via real failures already moved
    the counter."""

    def __init__(self, flap_failures: int = 2,
                 flap_window_s: float = 60.0, **kw):
        kw.setdefault("severity", "critical")
        super().__init__("breaker_flap",
                         message="replica breakers flapping", **kw)
        self.flap_failures = max(1, flap_failures)
        self.flap_window_s = flap_window_s
        # pruned by TIME, not a fixed maxlen: a fixed ring at
        # sub-second alert intervals would silently shrink the window
        # (256 samples at 0.2 s cover 51 s of a configured 60)
        self._samples: deque = deque()  # (t, failures_total)

    def evaluate(self, signals):
        now = signals.get("now", time.monotonic())
        failures = signals.get("replica_failures", 0)
        self._samples.append((now, failures))
        horizon = now - self.flap_window_s
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()
        recent = failures - self._samples[0][1]
        if recent >= self.flap_failures:
            unhealthy = [s for s in signals.get("states", ())
                         if s in ("broken", "probing")]
            return {"failures_in_window": recent,
                    "window_s": self.flap_window_s,
                    "unhealthy_replicas": len(unhealthy)}
        return None


class ShedStormRule(Rule):
    """Capacity sheds clustering in time: the gateway is 429/503-ing
    clients faster than ``storm_count`` per ``storm_window_s`` — a
    connection storm is hitting the admission gate and real requests
    are bouncing off it. Fires on the RATE of the cumulative
    ``shed_capacity_total`` counter (quota 429s are already excluded
    upstream — a tenant over its own rate limit is policy, not an
    incident), with the same time-pruned sample window as
    ``BreakerFlapRule``: a fixed-length ring at sub-second alert
    intervals would silently shrink the window. Before this rule, a
    storm's sheds moved /stats and the autoscaler but never the alert
    bus — the one surface operators actually page on.

    Counts BOTH planes (closing a gap of the
    reference's ROADMAP): admission-layer capacity sheds AND the network edge's
    connection-cap 429s (``edge_conn_limit_sheds``) — a pure
    connection storm bounces off the edge without ever reaching
    admission, and used to be invisible here."""

    def __init__(self, storm_count: int = 50,
                 storm_window_s: float = 10.0, **kw):
        kw.setdefault("severity", "critical")
        super().__init__("shed_storm",
                         message="capacity sheds storming", **kw)
        self.storm_count = max(1, storm_count)
        self.storm_window_s = storm_window_s
        self._samples: deque = deque()  # (t, sheds incl. edge)

    def evaluate(self, signals):
        now = signals.get("now", time.monotonic())
        shed = signals.get("shed_capacity_total", 0) \
            + signals.get("edge_conn_limit_sheds", 0)
        self._samples.append((now, shed))
        horizon = now - self.storm_window_s
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()
        recent = shed - self._samples[0][1]
        if recent >= self.storm_count:
            return {"sheds_in_window": recent,
                    "window_s": self.storm_window_s,
                    "threshold": self.storm_count}
        return None


class GatewayRecoveryRule(Rule):
    """The gateway came back from a CRASH (``--recover`` replayed a
    journal) within the last ``recent_s`` — informational, but an
    operator should KNOW the process died and restarted even when
    recovery made it invisible to clients: repeated firings are a
    crash loop. Fires immediately (``fire_after=1``) and resolves on
    its own once the recovery ages out of the window."""

    def __init__(self, recent_s: float = 60.0, **kw):
        kw.setdefault("severity", "warning")
        super().__init__("gateway_recovery",
                         message="gateway restarted from crash "
                                 "recovery", **kw)
        self.recent_s = recent_s

    def evaluate(self, signals):
        ago = signals.get("recovered_ago_s")
        if ago is not None and ago <= self.recent_s:
            return {"recovered_ago_s": ago}
        return None


class GoodputCollapseRule(Rule):
    """Fleet useful fraction dropping hard below its own trailing
    baseline while real work is running — the "the fleet is busy but
    the work is going somewhere else" alarm (a compile storm, a
    padding regression, a speculation meltdown). Works on PER-TICK
    DELTAS of the ledger's useful vs DISPATCH milliseconds — "of the
    time the engines spent dispatching this tick, how much landed
    kept tokens" — never the since-boot cumulative fraction and never
    a wall-clock denominator: the cumulative ratio would fire falsely
    on the first request after a long idle lull and lag real
    collapses by the whole uptime, and a wall denominator would read
    trickle traffic (one short request in a mostly-idle second) as a
    collapse. Ticks with under ``min_dispatch_ms`` of dispatch
    activity are not judged at all. The baseline is an EMA over
    judged ticks, armed after ``min_updates``; a collapse tick does
    NOT update the baseline (it must not chase the regression
    down)."""

    def __init__(self, collapse_frac: float = 0.5,
                 min_updates: int = 5, decay: float = 0.8,
                 min_dispatch_ms: float = 20.0, **kw):
        kw.setdefault("severity", "critical")
        super().__init__("goodput_collapse",
                         message="goodput collapsed vs baseline", **kw)
        self.collapse_frac = collapse_frac
        self.min_updates = max(1, min_updates)
        self.decay = decay
        self.min_dispatch_ms = min_dispatch_ms
        self.baseline: float | None = None
        self._updates = 0
        self._prev_tokens = 0
        self._prev_ms: tuple | None = None  # (useful_ms, dispatch_ms)

    def evaluate(self, signals):
        useful_ms = signals.get("goodput_useful_ms")
        dispatch_ms = signals.get("goodput_dispatch_ms")
        tokens = signals.get("tokens_out", 0)
        flowing = tokens > self._prev_tokens
        self._prev_tokens = tokens
        if useful_ms is None or dispatch_ms is None:
            return None
        prev, self._prev_ms = self._prev_ms, (useful_ms, dispatch_ms)
        if prev is None or not flowing:
            return None
        d_disp = dispatch_ms - prev[1]
        if d_disp < self.min_dispatch_ms:
            return None  # not enough device work this tick to judge
        frac = min(1.0, max(0.0, useful_ms - prev[0]) / d_disp)
        armed = self._updates >= self.min_updates
        collapsed = (armed and self.baseline is not None
                     and self.baseline > 0
                     and frac < self.collapse_frac * self.baseline)
        if not collapsed:
            self.baseline = frac if self.baseline is None else \
                self.decay * self.baseline + (1 - self.decay) * frac
            self._updates += 1
            return None
        return {"useful_fraction": round(frac, 4),
                "baseline": round(self.baseline, 4),
                "collapse_frac": self.collapse_frac}


def default_rules(thresholds: dict | None = None) -> list[Rule]:
    """The stock rule set; ``thresholds`` overrides any of
    queue_wait_s / kv_free_frac / ttft_slo_s / burn_frac /
    flap_failures / flap_window_s / shed_storm_count /
    shed_storm_window_s / collapse_frac."""
    t = thresholds or {}
    return [
        QueueAgingRule(queue_wait_s=t.get("queue_wait_s", 5.0)),
        KvPagesPressureRule(kv_free_frac=t.get("kv_free_frac", 0.15)),
        KvHostThrashRule(
            thrash_bytes=t.get("host_thrash_bytes", float(1 << 20)),
            kv_free_frac=t.get("kv_free_frac", 0.15)),
        TtftSloBurnRule(ttft_slo_s=t.get("ttft_slo_s", 0.0),
                        burn_frac=t.get("burn_frac", 0.10)),
        BreakerFlapRule(flap_failures=t.get("flap_failures", 2),
                        flap_window_s=t.get("flap_window_s", 60.0)),
        ShedStormRule(storm_count=t.get("shed_storm_count", 50),
                      storm_window_s=t.get("shed_storm_window_s", 10.0)),
        GoodputCollapseRule(
            collapse_frac=t.get("collapse_frac", 0.5)),
        GatewayRecoveryRule(
            recent_s=t.get("recovery_recent_s", 60.0)),
    ]


class AlertBus:
    """Rule evaluation + transition dedup + bounded event history.
    Thread-safe: the gateway's alert loop evaluates, any HTTP thread
    snapshots."""

    def __init__(self, rules: list[Rule] | None = None,
                 recent_capacity: int = 128):
        self.rules = list(rules) if rules is not None \
            else default_rules()
        self._lock = threading.Lock()
        self._active: dict[str, AlertEvent] = {}
        self._streak: dict[str, int] = {}   # +n firing / -n clear
        self._recent: deque[AlertEvent] = deque(maxlen=recent_capacity)
        self.fired: dict[str, int] = {}
        self.resolved: dict[str, int] = {}
        self.evaluations = 0

    def evaluate(self, signals: dict,
                 t_wall: float | None = None) -> list[AlertEvent]:
        """One tick over every rule; returns the TRANSITIONS (fire /
        resolve events) this tick produced. A rule that raises is
        counted clear — a broken rule must never take the serving
        loop's monitor down with it."""
        t_wall = time.time() if t_wall is None else t_wall
        out: list[AlertEvent] = []
        with self._lock:
            self.evaluations += 1
            for rule in self.rules:
                try:
                    detail = rule.evaluate(signals)
                except Exception:  # noqa: BLE001 — see docstring
                    detail = None
                streak = self._streak.get(rule.name, 0)
                if detail is not None:
                    streak = streak + 1 if streak > 0 else 1
                    active = self._active.get(rule.name)
                    if active is None and streak >= rule.fire_after:
                        ev = AlertEvent(rule.name, rule.severity,
                                        "firing", rule.message, t_wall,
                                        detail)
                        self._active[rule.name] = ev
                        self._recent.append(ev)
                        self.fired[rule.name] = \
                            self.fired.get(rule.name, 0) + 1
                        out.append(ev)
                    elif active is not None:
                        active.detail = detail  # live detail refresh
                else:
                    streak = streak - 1 if streak < 0 else -1
                    active = self._active.get(rule.name)
                    if active is not None \
                            and -streak >= rule.resolve_after:
                        ev = AlertEvent(rule.name, rule.severity,
                                        "resolved", rule.message,
                                        t_wall,
                                        {"fired_at": active.t_wall})
                        del self._active[rule.name]
                        self._recent.append(ev)
                        self.resolved[rule.name] = \
                            self.resolved.get(rule.name, 0) + 1
                        out.append(ev)
                self._streak[rule.name] = streak
        return out

    def active(self) -> list[AlertEvent]:
        with self._lock:
            return list(self._active.values())

    def snapshot(self) -> dict:
        """The ``/stats`` ``alerts`` block."""
        with self._lock:
            return {
                "rules": [r.name for r in self.rules],
                "evaluations": self.evaluations,
                "active": [{
                    "alert": e.alert, "severity": e.severity,
                    "since": round(e.t_wall, 3),
                    "message": e.message, "detail": dict(e.detail),
                } for e in self._active.values()],
                "recent": [e.to_row() for e in self._recent],
                "fired": dict(self.fired),
                "resolved": dict(self.resolved),
            }
