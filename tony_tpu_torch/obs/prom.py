"""Dependency-free Prometheus text exposition (format 0.0.4).

The PyTorch port's copy of ``tony_tpu/obs/prom.py``.

The gateway already collects everything an autoscaler or scrape agent
needs — counters, gauges, latency distributions — but spoke only JSON
(``/stats``). This module renders the standard text format without any
client library: ``MetricFamily`` (one ``# HELP``/``# TYPE`` header +
samples), ``Histogram`` (fixed-bucket cumulative with ``_bucket``/
``_sum``/``_count`` rendering), and the label-escaping rules from the
exposition spec (backslash, double-quote, newline escaped in label
values; metric/label names restricted to ``[a-zA-Z_][a-zA-Z0-9_]*``).

``Histogram`` is also the gateway's internal latency accumulator: the
rolling ``/stats`` window keeps exact recent percentiles, the
histogram keeps LIFETIME distributions in fixed buckets — the form a
scraper can rate() and aggregate across replicas, which a windowed
percentile cannot.
"""

from __future__ import annotations

import math
import threading

# latency buckets in SECONDS (the prometheus base-unit convention),
# log-spaced from 1 ms to 60 s: wide enough for queue waits under
# load shedding, fine enough to resolve a 10 ms TPOT regression
DEFAULT_TIME_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def escape_label_value(value) -> str:
    """Exposition-spec label escaping: backslash first, then quote and
    newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(value) -> str:
    """Sample value formatting: integers render bare (no trailing .0),
    floats via repr-ish shortest form, specials per the spec."""
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int):
        return str(value)
    v = float(value)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _labels(labels: dict | None) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


class MetricFamily:
    """One metric name: HELP/TYPE header + samples. ``mtype`` is
    "counter" | "gauge" | "histogram" (untyped renders as gauge)."""

    def __init__(self, name: str, mtype: str, help_text: str):
        self.name = name
        self.mtype = mtype
        self.help = help_text
        self.samples: list[tuple[str, dict | None, float]] = []

    def add(self, value, labels: dict | None = None,
            suffix: str = "") -> "MetricFamily":
        self.samples.append((self.name + suffix, labels, value))
        return self

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.mtype}"]
        for name, labels, value in self.samples:
            lines.append(f"{name}{_labels(labels)} {_fmt(value)}")
        return "\n".join(lines)


class Histogram:
    """Thread-safe fixed-bucket histogram. ``observe()`` is two adds
    under a lock — cheap enough for the request-done path. Buckets are
    stored non-cumulative and rendered cumulative (the exposition
    format), always ending in ``+Inf``."""

    def __init__(self, buckets: tuple = DEFAULT_TIME_BUCKETS_S):
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf tail
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = 0
        for i, b in enumerate(self.buckets):  # noqa: B007 — linear scan:
            # len(buckets) ~ 15, a bisect would not pay for itself
            if value <= b:
                break
        else:
            i = len(self.buckets)
        with self._lock:
            self._counts[i] += 1
            self.sum += value
            self.count += 1

    def family(self, name: str, help_text: str,
               labels: dict | None = None) -> MetricFamily:
        fam = MetricFamily(name, "histogram", help_text)
        with self._lock:
            counts = list(self._counts)
            total, s = self.count, self.sum
        cum = 0
        for b, c in zip(self.buckets, counts):
            cum += c
            fam.add(cum, {**(labels or {}), "le": _fmt(b)},
                    suffix="_bucket")
        fam.add(total, {**(labels or {}), "le": "+Inf"}, suffix="_bucket")
        fam.add(s, labels, suffix="_sum")
        fam.add(total, labels, suffix="_count")
        return fam

    def snapshot(self) -> dict:
        """JSON-friendly view for /stats debugging."""
        with self._lock:
            return {"count": self.count, "sum": round(self.sum, 6),
                    "buckets": dict(zip([_fmt(b) for b in self.buckets]
                                        + ["+Inf"], self._counts))}


def hist_over_edge(hist_snapshot: dict, threshold: float) -> tuple:
    """``(samples over the threshold, total samples)`` from a
    ``Histogram.snapshot()`` dict. The threshold rounds UP to the next
    bucket edge: the straddling bucket (values <= that edge, possibly
    all meeting the threshold) counts as WITHIN — a threshold between
    edges must not report the whole fleet as over. ONE implementation
    shared by the autoscaler's TTFT-SLO-burn signal and the alert
    bus's ``ttft_slo_burn`` rule, so a scale decision and an alert can
    never disagree about the same histogram."""
    total = hist_snapshot.get("count", 0)
    buckets = [(float("inf") if le == "+Inf" else float(le), n)
               for le, n in hist_snapshot.get("buckets", {}).items()]
    eff = min((e for e, _ in buckets if e >= threshold),
              default=float("inf"))
    over = sum(n for e, n in buckets if e > eff)
    return over, total


def render(families: list[MetricFamily]) -> str:
    """The whole exposition document (trailing newline included, as
    the spec requires)."""
    return "\n".join(f.render() for f in families if f.samples) + "\n"
