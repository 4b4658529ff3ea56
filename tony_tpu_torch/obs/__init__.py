"""End-to-end serving observability: traces, timeline, exposition.

The PyTorch port's copy of ``tony_tpu/obs/__init__.py``.

The TonY lesson (PAPER.md L4/L6) applied to serving: orchestration is
worth little if you cannot see where a request's time went. Three
layers, each consumable on its own:

- ``trace``: per-request span trees (queue-wait -> admit -> decode
  rounds, one attempt span per engine run across failovers), exported
  as Chrome trace-event JSON for Perfetto (``/debug/trace/<id>``);
- ``timeline``: per-dispatch engine records (kind / occupancy / shape
  bucket / host-wall duration, compile split from steady state) — the
  ``/stats`` ``dispatches`` block and the sensor for dispatch-overhead
  work;
- ``prom`` + ``export``: dependency-free Prometheus text exposition of
  the gateway's counters, gauges, and latency histograms
  (``GET /metrics``).

- ``goodput`` + ``alerts``: the attribution layer — an analytic
  bytes/FLOPs cost model stamped onto every timeline record, a
  wall-clock goodput ledger whose named buckets sum to <= 1
  (``/stats`` ``engine.goodput``, ``GET /debug/goodput``), and a
  rule-engine alert bus emitting deduplicated fire/resolve events
  (``/stats`` ``alerts``, history ``metrics/alerts.jsonl``).

The whole layer is always-on-cheap (appends under small locks, export
cost only when asked); bench ``extras.obs`` and ``extras.goodput``
pin the overhead.
"""

from tony_tpu_torch.obs.alerts import AlertBus, AlertEvent, Rule, default_rules
from tony_tpu_torch.obs.export import prometheus_text
from tony_tpu_torch.obs.goodput import (CostModel, detect_hbm_gbps,
                                  detect_peak_flops, ledger,
                                  merge_ledgers)
from tony_tpu_torch.obs.prom import (DEFAULT_TIME_BUCKETS_S, Histogram,
                               MetricFamily, escape_label_value, render)
from tony_tpu_torch.obs.timeline import DispatchRecord, DispatchTimeline
from tony_tpu_torch.obs.trace import (RequestTrace, Span, TraceBuffer,
                                check_invariants)

__all__ = [
    "DEFAULT_TIME_BUCKETS_S",
    "AlertBus",
    "AlertEvent",
    "CostModel",
    "DispatchRecord",
    "DispatchTimeline",
    "Histogram",
    "MetricFamily",
    "RequestTrace",
    "Rule",
    "Span",
    "TraceBuffer",
    "check_invariants",
    "default_rules",
    "detect_hbm_gbps",
    "detect_peak_flops",
    "escape_label_value",
    "ledger",
    "merge_ledgers",
    "prometheus_text",
    "render",
]
