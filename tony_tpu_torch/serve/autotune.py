"""Ledger-driven adaptive shape controller (ROADMAP 4c).

The PyTorch port's copy of ``tony_tpu/serve/autotune.py``.

The serving engine's hot-loop shape knobs — ``chunk_steps`` (decode
micro-steps fused per dispatch), ``speculate_k`` (draft window), and
``prefill_chunk`` (prompt tokens per admission dispatch) — were static
CLI settings an operator had to tune per workload. The goodput
ledger can now *price* each setting live: the padding / overshoot /
spec_rejected fractions and the per-kind dispatch aggregates say
exactly which knob is wasting time. This module closes the loop: a
host-side controller samples each replica's timeline deltas every tick
and steers the knobs within operator-configured bounds.

Design constraints, in order:

- **Output-invariant.** Every knob it touches is output-invariant by
  the engine's own exactness pins (chunk-invariance, spec on/off
  parity, chunked-prefill parity), so an actuation can NEVER change a
  request's tokens — only the dispatch schedule.
- **No compile storms.** Actuations move on the power-of-two grid the
  engine's programs are already bucketed on, one step per actuation,
  with hysteresis (``hold_ticks`` consecutive same-direction proposals
  before acting) and a per-knob cooldown afterwards — so each
  actuation lands on an already-compiled bucket or deliberately pays
  ONE new compile, and the decision row says which
  (``new_compile``).
- **Idle replicas are never actuated.** A tick that saw fewer than
  ``min_dispatches`` decode/verify dispatches carries no signal;
  acting on it would be noise-chasing (and the convergence contract —
  actuations stop on steady traffic — would be unfalsifiable).
- **Bounded convergence.** Every rule moves a knob monotonically
  toward a bound or a dead zone; once traffic is steady the streaks
  stop refreshing and the controller goes quiet. ``converged`` in the
  snapshot is that condition made visible.

The controller is deliberately engine-local (it reads
``server.timeline.summary()`` + ``server.counters()`` and writes
``server.chunk_steps`` etc. — plain host attributes the scheduler
re-reads each round, so cross-thread actuation is safe: the new value
simply applies from the next round). Remote replicas have no local
timeline and are skipped. The gateway wires it into a sampling thread
and threads decisions to ``/stats engine.autotune``,
``tony_autotune_*`` metrics, and history ``metrics/autotune.jsonl``
(gateway/core.py).
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field

log = logging.getLogger(__name__)


def _pow2_down(n: int) -> int:
    """Largest power of two <= n (n >= 1) — actuations live on the
    same pow2 grid the engine's program buckets do."""
    b = 1
    while b * 2 <= n:
        b *= 2
    return b


def _pow2_up(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


@dataclass
class KnobBounds:
    """Operator bounds for one knob. ``lo == hi`` pins the knob (the
    controller will never propose a move); ``hi == 0`` disables
    tuning of that knob entirely."""

    lo: int
    hi: int

    def clamp(self, v: int) -> int:
        return max(self.lo, min(self.hi, v))


@dataclass
class _KnobState:
    """Per-(replica, knob) hysteresis: a proposal must repeat
    ``hold_ticks`` times in the SAME direction before it actuates, and
    a fresh actuation starts a cooldown during which proposals are
    ignored (the new shape needs a few ticks of data before being
    judged)."""

    direction: int = 0   # -1 shrink / +1 grow of the pending streak
    streak: int = 0
    cooldown: int = 0


@dataclass
class _ReplState:
    """Per-replica sampling state: the previous cumulative sample the
    next tick diffs against (first tick only establishes the
    baseline)."""

    prev: dict | None = None
    knobs: dict = field(default_factory=dict)  # knob name -> _KnobState


# the step-shaped dispatch kinds whose deltas carry the decode-loop
# signal (prefill-shaped kinds feed the prefill_chunk rule instead)
_STEP_KINDS = ("decode", "verify")


class AutotuneController:
    """See the module docstring. ``tick(replicas)`` takes
    ``[(index, server), ...]``, samples each local engine, and applies
    at most one actuation per knob per replica; it returns the
    decision rows it actuated (for logging / history). Thread-safety:
    tick() is called from ONE loop thread; snapshot() may be read from
    any (it only copies plain fields)."""

    def __init__(self, *,
                 chunk_bounds: tuple = (1, 32),
                 spec_bounds: tuple = (0, 16),
                 prefill_bounds: tuple = (0, 0),
                 hold_ticks: int = 2, cooldown_ticks: int = 3,
                 min_dispatches: int = 4,
                 overshoot_hi: float = 0.05,
                 overshoot_lo: float = 0.01,
                 frozen_hi: float = 0.50,
                 reject_hi: float = 0.35,
                 accept_hi: float = 0.60,
                 history: int = 64):
        self.chunk_bounds = KnobBounds(*chunk_bounds)
        self.spec_bounds = KnobBounds(*spec_bounds)
        self.prefill_bounds = KnobBounds(*prefill_bounds)
        self.hold_ticks = max(1, int(hold_ticks))
        self.cooldown_ticks = max(0, int(cooldown_ticks))
        self.min_dispatches = max(1, int(min_dispatches))
        self.overshoot_hi = float(overshoot_hi)
        self.overshoot_lo = float(overshoot_lo)
        self.frozen_hi = float(frozen_hi)
        self.reject_hi = float(reject_hi)
        self.accept_hi = float(accept_hi)
        self._st: dict = {}
        self.ticks = 0
        self.idle_ticks = 0
        self.actuation_counts: dict[str, int] = {}
        self.new_compiles = 0
        self.last_actuation_tick = 0
        self.recent: deque = deque(maxlen=max(1, history))

    # ------------------------------------------------------- sampling

    def _sample(self, server) -> dict | None:
        """One cumulative reading of the engine's shape-relevant
        sensors; None for engines with no timeline (timeline=False)
        and for REMOTE stubs — such replicas are never actuated. The
        remote check is explicit (a transport marks a stub) rather
        than timeline-is-None: now stubs carry a pulled
        RemoteTimeline, but their shape knobs live on the AGENT's
        engine — actuating the stub's dead local attributes would log
        phantom decisions that never reach the device."""
        timeline = getattr(server, "timeline", None)
        if timeline is None or getattr(server, "transport",
                                       None) is not None:
            return None
        summ = timeline.summary()
        out = {"dispatches": 0, "tokens": 0, "work": 0,
               "steady_ms": 0.0, "useful_ms": 0.0, "padding_ms": 0.0,
               "overshoot_ms": 0.0, "rejected_ms": 0.0,
               "prefill_steady_ms": 0.0, "prefill_padding_ms": 0.0,
               "prefill_count": 0}
        for kind in _STEP_KINDS:
            a = summ.get(kind)
            if not a:
                continue
            out["dispatches"] += a["count"]
            out["tokens"] += a["tokens"]
            out["work"] += a.get("work", 0)
            out["steady_ms"] += a["ms"] - a["compile_ms"]
            out["useful_ms"] += a["useful_ms"]
            out["padding_ms"] += a["padding_ms"]
            out["overshoot_ms"] += a["overshoot_ms"]
            out["rejected_ms"] += a["rejected_ms"]
        out["frozen_steps"] = getattr(server, "frozen_steps", 0)
        for kind in ("prefill", "prefill_chunk"):
            a = summ.get(kind)
            if not a:
                continue
            out["prefill_count"] += a["count"]
            out["prefill_steady_ms"] += a["ms"] - a["compile_ms"]
            out["prefill_padding_ms"] += a["padding_ms"]
        out["spec_drafted"] = getattr(server, "spec_drafted", 0)
        out["spec_accepted"] = getattr(server, "spec_accepted", 0)
        return out

    @staticmethod
    def _delta(prev: dict, cur: dict) -> dict:
        return {k: cur[k] - prev.get(k, 0) for k in cur}

    # ------------------------------------------------------ proposals

    def _proposals(self, server, d: dict) -> list:
        """Rule evaluation over one tick's deltas -> [(knob, target,
        direction, reason, signals)]. Each rule is a monotone move
        toward a bound or a dead zone, so steady traffic converges."""
        out = []
        steady = max(d["steady_ms"], 1e-9)
        overshoot = d["overshoot_ms"] / steady
        padding = d["padding_ms"] / steady
        # frozen re-emits as a fraction of the step dispatches'
        # POSITION capacity: the chunk-depth-induced share of padding.
        # Empty-slot padding (low occupancy) is orthogonal to
        # chunk_steps and must not veto growth.
        frozen = d["frozen_steps"] / max(1, d["work"])
        signals = {"overshoot_frac": round(overshoot, 4),
                   "padding_frac": round(padding, 4),
                   "frozen_frac": round(frozen, 4),
                   "dispatches": d["dispatches"],
                   "tokens": d["tokens"]}

        # chunk_steps: overshoot says the chunk runs past finishes the
        # engine pays for (only possible with in-dispatch EOS off, or
        # on the verify path) -> shrink; a clean ledger whose frozen
        # share leaves headroom -> grow toward the bound, amortizing
        # the per-dispatch host cost over more tokens. Judged only on
        # ticks that actually ran decode/verify dispatches — a
        # prefill-only tick carries no decode-shape signal.
        cur = int(getattr(server, "chunk_steps", 0))
        bounds = self.chunk_bounds
        if bounds.hi > 0 and cur > 0 \
                and d["dispatches"] >= self.min_dispatches:
            if overshoot > self.overshoot_hi \
                    and bounds.clamp(_pow2_down(cur) // 2 or 1) < cur:
                out.append(("chunk_steps",
                            bounds.clamp(_pow2_down(cur) // 2 or 1),
                            -1, "overshoot", signals))
            elif frozen > (1.0 + self.frozen_hi) / 2 \
                    and bounds.clamp(_pow2_down(cur) // 2 or 1) < cur:
                # most positions re-emit frozen finals: the chunk is
                # far deeper than the workload's typical remaining
                # budget — walk it back
                out.append(("chunk_steps",
                            bounds.clamp(_pow2_down(cur) // 2 or 1),
                            -1, "frozen", signals))
            elif overshoot <= self.overshoot_lo \
                    and frozen < self.frozen_hi \
                    and bounds.clamp(_pow2_up(cur) * 2) > cur:
                out.append(("chunk_steps",
                            bounds.clamp(_pow2_up(cur) * 2),
                            +1, "amortize_dispatches", signals))

        # speculate_k: judged on this tick's draft economics alone.
        # Never re-arms from 0 — a disabled path produces no data to
        # justify enabling it.
        cur = int(getattr(server, "speculate_k", 0))
        bounds = self.spec_bounds
        drafted = d.get("spec_drafted", 0)
        if bounds.hi > 0 and cur > 0 and drafted > 0:
            rej = 1.0 - d.get("spec_accepted", 0) / drafted
            sig = dict(signals, drafted=drafted,
                       reject_frac=round(rej, 4))
            if rej > self.reject_hi \
                    and bounds.clamp(_pow2_down(cur) // 2) < cur:
                out.append(("speculate_k",
                            bounds.clamp(_pow2_down(cur) // 2),
                            -1, "spec_rejected", sig))
            elif rej < 1.0 - self.accept_hi \
                    and bounds.clamp(_pow2_up(cur) * 2) > cur:
                out.append(("speculate_k",
                            bounds.clamp(_pow2_up(cur) * 2),
                            +1, "spec_accepted", sig))

        # prefill chunk budget: a padding-heavy prefill mix means the
        # chunk windows are wider than the prompts feeding them ->
        # shrink; pad-free chunked prefills -> grow toward the bound
        # (fewer interleave rounds per long prompt). The engine floor
        # is its bucket minimum.
        cur = int(getattr(server, "prefill_chunk", 0))
        bounds = self.prefill_bounds
        if bounds.hi > 0 and cur > 0 \
                and d["prefill_count"] >= self.min_dispatches:
            pf_steady = max(d["prefill_steady_ms"], 1e-9)
            pf_pad = d["prefill_padding_ms"] / pf_steady
            floor = max(bounds.lo, int(getattr(server, "min_bucket",
                                               16)))
            sig = dict(signals, prefill_padding_frac=round(pf_pad, 4),
                       prefill_count=d["prefill_count"])
            if pf_pad > 0.5 and max(floor, _pow2_down(cur) // 2) < cur:
                out.append(("prefill_chunk",
                            min(bounds.hi,
                                max(floor, _pow2_down(cur) // 2)),
                            -1, "prefill_padding", sig))
            elif pf_pad < 0.1 \
                    and bounds.clamp(_pow2_up(cur) * 2) > cur:
                out.append(("prefill_chunk",
                            bounds.clamp(_pow2_up(cur) * 2),
                            +1, "prefill_interleave", sig))
        return out

    # ------------------------------------------------------ actuation

    def _lands_on_compiled(self, server, knob: str, target: int) -> bool:
        """Whether the target value's graph key is already captured on
        this engine (``server.graphs``, paged or unpaged kinds) — the
        'no capture storm' receipt each decision row carries
        (``new_compile``: the first call at a new key runs eagerly and
        is captured). Conservative: no graph cache (the CPU) or an
        unknown knob reports False."""
        graphs = getattr(server, "graphs", None)
        keys = list(graphs.entries) if graphs is not None else []
        if not keys:
            return False
        if knob == "chunk_steps":
            return any(k[0] in ("decode", "chunk_rows") and len(k) > 1
                       and k[1] == target for k in keys)
        if knob == "speculate_k":
            # verify windows are pow2(draft)+1 bucketed; a smaller k
            # reuses the windows a bigger k already captured
            return any(k[0] in ("verify", "verify_rows") and len(k) > 1
                       and k[1] <= _pow2_up(max(1, target)) + 1
                       for k in keys)
        if knob == "prefill_chunk":
            return any(k[0] == "prefill_chunk" and len(k) > 1
                       and k[1] == target for k in keys)
        return False

    def tick(self, replicas: list) -> list[dict]:
        """One controller evaluation over ``[(index, server), ...]``.
        Returns the actuation rows applied this tick."""
        self.ticks += 1
        decisions = []
        for index, server in replicas:
            if server is None:
                continue
            sample = self._sample(server)
            if sample is None:
                continue
            st = self._st.setdefault(index, _ReplState())
            prev, st.prev = st.prev, sample
            if prev is None:
                continue  # baseline tick: nothing to diff yet
            d = self._delta(prev, sample)
            for ks in st.knobs.values():
                if ks.cooldown > 0:
                    ks.cooldown -= 1
            if d["dispatches"] < self.min_dispatches \
                    and d["prefill_count"] < self.min_dispatches:
                # idle replica: no signal, no actuation, and stale
                # streaks must not fire the moment traffic returns
                self.idle_ticks += 1
                for ks in st.knobs.values():
                    ks.streak, ks.direction = 0, 0
                continue
            proposals = self._proposals(server, d)
            proposed = {p[0] for p in proposals}
            for knob, target, direction, reason, sig in proposals:
                ks = st.knobs.setdefault(knob, _KnobState())
                if ks.cooldown > 0:
                    continue
                if ks.direction == direction:
                    ks.streak += 1
                else:
                    ks.direction, ks.streak = direction, 1
                if ks.streak < self.hold_ticks:
                    continue
                cur = int(getattr(server, knob))
                if target == cur:
                    ks.streak, ks.direction = 0, 0
                    continue
                new_compile = not self._lands_on_compiled(
                    server, knob, target)
                setattr(server, knob, target)
                ks.streak, ks.direction = 0, 0
                # +1: the per-tick decrement runs before the judgment,
                # so this blocks exactly cooldown_ticks judgments
                ks.cooldown = self.cooldown_ticks + 1
                row = {"t": time.time(), "replica": index,
                       "knob": knob, "from": cur, "to": target,
                       "reason": reason, "signals": sig,
                       "new_compile": new_compile, "tick": self.ticks}
                self.actuation_counts[knob] = \
                    self.actuation_counts.get(knob, 0) + 1
                self.new_compiles += int(new_compile)
                self.last_actuation_tick = self.ticks
                self.recent.append(row)
                decisions.append(row)
                log.info(
                    "autotune replica %d: %s %d -> %d (%s%s)", index,
                    knob, cur, target, reason,
                    ", pays one new compile" if new_compile else
                    ", already-compiled bucket")
            # a knob no rule proposed this tick loses its streak —
            # hysteresis means N CONSECUTIVE proposals
            for knob, ks in st.knobs.items():
                if knob not in proposed:
                    ks.streak, ks.direction = 0, 0
        return decisions

    # ------------------------------------------------------- surfaces

    def knob_values(self, replicas: list) -> dict:
        """Current knob values per replica (for /stats + /metrics
        gauges) — read live from the engines, so the numbers can never
        drift from what the scheduler actually uses."""
        out = {}
        for index, server in replicas:
            if server is None or getattr(server, "timeline", None) \
                    is None:
                continue
            out[index] = {
                "chunk_steps": int(getattr(server, "chunk_steps", 0)),
                "speculate_k": int(getattr(server, "speculate_k", 0)),
                "prefill_chunk": int(getattr(server, "prefill_chunk",
                                             0)),
            }
        return out

    def snapshot(self) -> dict:
        return {
            "enabled": True,
            "ticks": self.ticks,
            "idle_ticks": self.idle_ticks,
            "actuations": dict(self.actuation_counts),
            "actuations_total": sum(self.actuation_counts.values()),
            "new_compiles": self.new_compiles,
            "last_actuation_tick": self.last_actuation_tick,
            # quiet for a full hysteresis+cooldown horizon = converged
            "converged": self.ticks - self.last_actuation_tick
            > self.hold_ticks + self.cooldown_ticks,
            "bounds": {
                "chunk_steps": [self.chunk_bounds.lo,
                                self.chunk_bounds.hi],
                "speculate_k": [self.spec_bounds.lo,
                                self.spec_bounds.hi],
                "prefill_chunk": [self.prefill_bounds.lo,
                                  self.prefill_bounds.hi],
            },
            "recent": list(self.recent)[-8:],
        }
