"""Per-dispatch engine timeline: what every device program launch cost.

The PyTorch port's copy of ``tony_tpu/obs/timeline.py``.

The serving engine's counters (prefills / decode_steps / dispatches)
say HOW MUCH device work ran; this module records WHEN and HOW LONG —
one ``DispatchRecord`` per engine dispatch (prefill, hit-admit, decode
chunk, spec-verify), with the live-slot occupancy, the program's shape
knob (prefill bucket / chunk depth / verify window), the tokens the
dispatch actually landed, and a first-call flag separating compile
(or compile-cache-load) time from steady state. This is the direct
sensor for ROADMAP item 4's dispatch-overhead attack: the roofline gap
shows up here as host-side milliseconds per dispatch that a per-kernel
profiler view cannot see.

Durations are HOST WALL time from just before the dispatch call to
just after the engine's host sync of its outputs — on an async backend
that includes device execution plus transfer, which is exactly the
latency a request experiences. The ``compile`` flag marks a first
call. In the port's engine (``serve/engine.py``) that is a CUDA-graph
key's first call, which runs eagerly and is then captured; the name
stays so that a record reads the same in both packages.

A bounded ring keeps recent records for trace attachment and debug;
cumulative per-kind aggregates survive eviction, so ``summary()`` (the
``/stats`` ``dispatches`` block) is lifetime-accurate. Appending is a
lock plus a dataclass — cheap enough to leave on in production, which
the obs overhead gate (bench ``extras.obs``) pins.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any


@dataclass
class DispatchRecord:
    """One engine dispatch. ``kind`` is "prefill" | "hit_admit" |
    "cow_admit" | "decode" | "verify" — cow_admit is the PAGED
    exact-prefix-hit admission (pages aliased host-side, one sampling
    dispatch): its own kind so per-kind ``tokens_per_dispatch`` never
    counts an aliasing admit as prefill work. ``bucket`` is the
    program's static shape knob (prefill bucket length, chunk depth,
    verify window — 0 for hit_admit/cow_admit); ``tokens`` counts
    tokens the dispatch landed for requests (trimmed overshoot
    excluded); ``request_id`` is set on admit dispatches (the engine
    id of the admitted request)."""

    kind: str
    t0: float          # time.monotonic() at dispatch start
    dur_ms: float      # host wall: dispatch + output sync
    occupancy: int     # live slots at dispatch time
    bucket: int
    tokens: int
    compile: bool      # first (kind, bucket) call on this engine
    request_id: Any = None
    tags: dict = field(default_factory=dict)
    seq: int = 0       # assigned by the timeline, monotonically
    # goodput-attribution fields (obs/goodput.py): ``work`` is the
    # program's static position capacity (chunk depth x batch, verify
    # window x batch, prefill bucket, 1 for admits), ``fed`` the
    # positions actually given real inputs (depth x occupancy,
    # last-token + drafts, suffix length), ``rejected`` the
    # speculative-draft positions the verify pass refused. The
    # duration split the ledger uses is exact by construction:
    # useful + padding + overshoot + rejected positions == work.
    # In-dispatch-EOS engines count a finished slot's
    # FROZEN positions (re-emits, no KV writes) as not-fed, so
    # fed == tokens on every decode record and the overshoot bucket
    # is structurally 0 — the frozen tail lands in padding next to
    # the empty-slot positions it behaves like (the record's
    # ``frozen`` tag carries the count).
    # ``est_bytes``/``est_flops`` are the CostModel's analytic program
    # cost (0 when no cost model is attached).
    work: int = 0
    fed: int = 0
    rejected: int = 0
    est_bytes: float = 0.0
    est_flops: float = 0.0


# wire codec (the agent's ``GET /v1/obs`` channel): every field a
# DispatchRecord carries, JSON-shaped. ``t0`` stays in the RECORDING
# process's monotonic clock — the puller owns the clock-offset
# correction (gateway/remote.py), because only it can estimate the
# offset (RTT-midpoint over its own heartbeats).
def record_doc(rec: DispatchRecord) -> dict:
    return {
        "seq": rec.seq, "kind": rec.kind, "t0": rec.t0,
        "dur_ms": rec.dur_ms, "occupancy": rec.occupancy,
        "bucket": rec.bucket, "tokens": rec.tokens,
        "compile": rec.compile, "request_id": rec.request_id,
        "tags": dict(rec.tags), "work": rec.work, "fed": rec.fed,
        "rejected": rec.rejected, "est_bytes": rec.est_bytes,
        "est_flops": rec.est_flops,
    }


def record_from_doc(doc: dict) -> DispatchRecord:
    rec = DispatchRecord(
        kind=str(doc.get("kind", "?")), t0=float(doc.get("t0", 0.0)),
        dur_ms=float(doc.get("dur_ms", 0.0)),
        occupancy=int(doc.get("occupancy", 0)),
        bucket=int(doc.get("bucket", 0)),
        tokens=int(doc.get("tokens", 0)),
        compile=bool(doc.get("compile", False)),
        request_id=doc.get("request_id"),
        tags=dict(doc.get("tags") or {}),
        work=int(doc.get("work", 0)), fed=int(doc.get("fed", 0)),
        rejected=int(doc.get("rejected", 0)),
        est_bytes=float(doc.get("est_bytes", 0.0)),
        est_flops=float(doc.get("est_flops", 0.0)))
    rec.seq = int(doc.get("seq", 0))
    return rec


class DispatchTimeline:
    """Ring of recent ``DispatchRecord``s + lifetime per-kind
    aggregates. Thread-safe; the engine records from its owner thread,
    readers (``/stats``, the trace attacher) snapshot from others."""

    # per-kind lifetime aggregate template; the *_ms split keys are the
    # goodput ledger's input (obs/goodput.py)
    _AGG_KEYS = ("count", "ms", "max_ms", "compiles", "compile_ms",
                 "tokens", "work", "fed", "est_bytes", "est_flops",
                 "est_bytes_steady", "est_flops_steady",
                 "useful_ms", "padding_ms", "overshoot_ms",
                 "rejected_ms")

    def __init__(self, capacity: int = 1024):
        self._lock = threading.Lock()
        self._ring: deque[DispatchRecord] = deque(maxlen=max(1, capacity))
        self._seq = 0
        self._agg: dict[str, dict[str, float]] = {}

    def record(self, rec: DispatchRecord) -> None:
        with self._lock:
            self._seq += 1
            rec.seq = self._seq
            self._ring.append(rec)
            agg = self._agg.setdefault(
                rec.kind, {k: 0.0 for k in self._AGG_KEYS})
            agg["count"] += 1
            agg["ms"] += rec.dur_ms
            agg["max_ms"] = max(agg["max_ms"], rec.dur_ms)
            agg["tokens"] += rec.tokens
            agg["work"] += rec.work
            agg["fed"] += rec.fed
            agg["est_bytes"] += rec.est_bytes
            agg["est_flops"] += rec.est_flops
            if rec.compile:
                # a first-call dispatch is all compile bucket: its
                # duration is dominated by program build / cache load,
                # and splitting it by positions would charge compile
                # time to "useful"
                agg["compiles"] += 1
                agg["compile_ms"] += rec.dur_ms
                return
            # steady-only cost sums: the utilization estimate divides
            # by steady milliseconds, so its numerator must exclude
            # compile-marked records too — lifetime est_bytes above
            # keeps pricing every dispatch for the /metrics counters
            agg["est_bytes_steady"] += rec.est_bytes
            agg["est_flops_steady"] += rec.est_flops
            work = max(1, rec.work)
            # useful positions: tokens LANDED for decode/verify; for a
            # prefill the landed-token count is 1 (the sampled first
            # token) but the useful work is the fed suffix window; the
            # single-position admits are all useful
            if rec.kind in ("prefill", "prefill_chunk"):
                # prefill-shaped dispatches: the landed-token count is
                # 1 (or 0 for an intermediate chunk) but the useful
                # work is the fed prompt window
                useful = min(rec.fed, work)
            elif rec.work <= 1:
                useful = work
            else:
                useful = min(rec.tokens, rec.fed)
            rejected = min(max(0, rec.rejected), max(0, rec.fed - useful))
            padding = max(0, work - max(rec.fed, useful))
            overshoot = max(0, work - useful - rejected - padding)
            agg["useful_ms"] += rec.dur_ms * useful / work
            agg["rejected_ms"] += rec.dur_ms * rejected / work
            agg["padding_ms"] += rec.dur_ms * padding / work
            agg["overshoot_ms"] += rec.dur_ms * overshoot / work

    def take_new(self, cursor: int) -> tuple[list[DispatchRecord], int]:
        """Records with ``seq > cursor`` still in the ring, plus the new
        cursor — the trace attacher's incremental read. Records evicted
        before being read are simply gone (bounded memory beats
        completeness for a debug surface). O(new), not O(ring): this
        runs on the replica scheduler loop every iteration under the
        same lock ``record()`` needs, so a full-ring scan per step
        would be pure hot-loop waste."""
        with self._lock:
            if self._seq == cursor:
                return [], cursor
            new = []
            for rec in reversed(self._ring):  # deque ends are O(1)
                if rec.seq <= cursor:
                    break
                new.append(rec)
            new.reverse()
            return new, self._seq

    @property
    def seq(self) -> int:
        """The last assigned sequence number (a ``since()``/cursor
        anchor for callers that will later want 'records after now')."""
        with self._lock:
            return self._seq

    def since(self, seq: int) -> list[DispatchRecord]:
        """Records with ``seq > seq`` still in the ring — the
        NON-destructive cousin of ``take_new`` (no cursor owned): the
        agent's per-request fragment gather anchors at the request's
        submit-time seq, so a finished request scans only its own
        lifetime's tail instead of the whole ring. O(new), same
        reverse-iterate-and-break as take_new."""
        with self._lock:
            if self._seq <= seq:
                return []
            out = []
            for rec in reversed(self._ring):
                if rec.seq <= seq:
                    break
                out.append(rec)
            out.reverse()
            return out

    def recent(self, n: int = 64) -> list[DispatchRecord]:
        with self._lock:
            return list(self._ring)[-n:]

    def summary(self) -> dict:
        """The ``/stats`` ``dispatches`` block: lifetime per-kind
        aggregates with compile time split out, so steady-state
        mean_ms answers "what does one dispatch cost" without the
        first-call spike polluting it. The goodput extension rides
        along: position accounting (``work``/``fed``), the analytic
        ``est_bytes``/``est_flops`` totals, and the per-kind duration
        split (``useful_ms``/``padding_ms``/``overshoot_ms``/
        ``rejected_ms``) the ledger folds with the wall clock."""
        out: dict = {}
        with self._lock:
            items = {k: dict(v) for k, v in self._agg.items()}
        for kind, a in sorted(items.items()):
            steady_n = a["count"] - a["compiles"]
            steady_ms = a["ms"] - a["compile_ms"]
            out[kind] = {
                "count": int(a["count"]),
                "ms": round(a["ms"], 3),
                "max_ms": round(a["max_ms"], 3),
                "compiles": int(a["compiles"]),
                "compile_ms": round(a["compile_ms"], 3),
                "steady_mean_ms": round(steady_ms / steady_n, 3)
                if steady_n else 0.0,
                "tokens": int(a["tokens"]),
                "tokens_per_dispatch": round(a["tokens"] / a["count"], 3)
                if a["count"] else 0.0,
                "work": int(a["work"]),
                "fed": int(a["fed"]),
                "est_bytes": round(a["est_bytes"], 1),
                "est_flops": round(a["est_flops"], 1),
                "est_bytes_steady": round(a["est_bytes_steady"], 1),
                "est_flops_steady": round(a["est_flops_steady"], 1),
                "useful_ms": round(a["useful_ms"], 3),
                "padding_ms": round(a["padding_ms"], 3),
                "overshoot_ms": round(a["overshoot_ms"], 3),
                "rejected_ms": round(a["rejected_ms"], 3),
            }
        return out

    # summed across replicas in merge(); max_ms maxes, means recompute
    _SUM_KEYS = ("count", "ms", "compiles", "compile_ms", "tokens",
                 "work", "fed", "est_bytes", "est_flops",
                 "est_bytes_steady", "est_flops_steady", "useful_ms",
                 "padding_ms", "overshoot_ms", "rejected_ms")

    @classmethod
    def merge(cls, summaries: list[dict]) -> dict:
        """Sum per-kind summaries across replicas (the fleet view the
        gateway's ``/stats`` carries): counts/ms/tokens/bytes/flops and
        the ledger splits add, max_ms maxes, means are recomputed from
        the merged totals."""
        merged: dict = {}
        for s in summaries:
            for kind, v in s.items():
                m = merged.setdefault(kind, dict.fromkeys(
                    cls._SUM_KEYS, 0.0))
                m["max_ms"] = max(m.get("max_ms", 0.0), v["max_ms"])
                for key in cls._SUM_KEYS:
                    m[key] += v.get(key, 0)
        for kind, m in merged.items():
            steady_n = m["count"] - m["compiles"]
            steady_ms = m["ms"] - m["compile_ms"]
            for key in ("count", "compiles", "tokens", "work", "fed"):
                m[key] = int(m[key])
            for key in ("ms", "compile_ms", "useful_ms", "padding_ms",
                        "overshoot_ms", "rejected_ms"):
                m[key] = round(m[key], 3)
            m["est_bytes"] = round(m["est_bytes"], 1)
            m["est_flops"] = round(m["est_flops"], 1)
            m["est_bytes_steady"] = round(m["est_bytes_steady"], 1)
            m["est_flops_steady"] = round(m["est_flops_steady"], 1)
            m["steady_mean_ms"] = round(steady_ms / steady_n, 3) \
                if steady_n else 0.0
            m["tokens_per_dispatch"] = round(m["tokens"] / m["count"], 3) \
                if m["count"] else 0.0
        return merged
