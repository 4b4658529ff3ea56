"""Reading the Chrome-trace JSON files that ``torch.profiler`` exports:
device-busy time and per-kernel totals without a profiler UI. The
counterpart of ``tony_tpu/profiler/xplane.py``, which reads the xplane
protos that ``jax.profiler`` writes.

A trace file is ``{"traceEvents": [...]}``. A complete event (``"ph":
"X"``) has a category (``cat``: ``"kernel"``, ``"gpu_memcpy"`` and
``"gpu_memset"`` on the card, ``"cpu_op"`` on the host), a name, a start
``ts`` and a duration ``dur`` in microseconds, and a ``pid``: the device
index for device events, the process id for host ones. One ``pid`` is
one plane here, named ``/device:GPU:<pid>`` for device events and
``/host:<pid>`` otherwise.

Kernels on two streams of one card can overlap, so a plane's busy time
is the union of its events' intervals, never their sum; across planes
``device_busy_ms`` reports the busiest plane (the critical path), not
the sum. Everything returns ``None`` where no file or no event of the
asked categories parses (a CPU-only trace has no kernel events), so a
caller can tell "not measured" from zero.
"""

from __future__ import annotations

import glob
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_files(logdir: str) -> list[str]:
    """Every Chrome-trace JSON file under ``logdir``, oldest first."""
    files = glob.glob(os.path.join(logdir, "**", "*.json"), recursive=True)
    return sorted(files, key=os.path.getmtime)


def load_trace(path: str) -> list | None:
    """The events of one trace file; None when it is truncated or not a
    trace (an interrupted export must not abort the caller)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    return events if isinstance(events, list) else None


def _plane(ev: dict) -> str:
    pid = ev.get("pid")
    return f"/device:GPU:{pid}" if ev.get("cat") in DEVICE_CATS \
        else f"/host:{pid}"


def _events(logdir: str, cats) -> dict[str, list] | None:
    """Complete events of categories ``cats``, by plane."""
    planes: dict[str, list] = {}
    for path in trace_files(logdir):
        for ev in load_trace(path) or ():
            if isinstance(ev, dict) and ev.get("ph") == "X" \
                    and ev.get("cat") in cats and "dur" in ev:
                planes.setdefault(_plane(ev), []).append(ev)
    return planes or None


def per_plane_op_totals_ms(logdir: str, cats=DEVICE_CATS) \
        -> dict[str, dict[str, float]] | None:
    """Plane name -> {event name -> ms summed} over every trace file
    under ``logdir``. None when nothing of ``cats`` parses."""
    planes = _events(logdir, cats)
    if planes is None:
        return None
    out: dict[str, dict[str, float]] = {}
    for plane, evs in planes.items():
        agg = out.setdefault(plane, {})
        for ev in evs:
            agg[ev["name"]] = agg.get(ev["name"], 0.0) + ev["dur"] / 1e3
    return out


def op_totals_ms(logdir: str, cats=DEVICE_CATS) -> dict[str, float] | None:
    """Event name -> ms summed over every plane and file (the per-kernel
    breakdown; for busy time comparable to the wall use
    ``device_busy_ms``). None when nothing of ``cats`` parses."""
    per_plane = per_plane_op_totals_ms(logdir, cats)
    if per_plane is None:
        return None
    totals: dict[str, float] = {}
    for plane_totals in per_plane.values():
        for name, ms in plane_totals.items():
            totals[name] = totals.get(name, 0.0) + ms
    return totals


def device_busy_ms(logdir: str, cats=DEVICE_CATS) -> float | None:
    """Busy ms of the busiest plane: the union of its events' intervals
    (overlapping streams count once). None when nothing of ``cats``
    parses, as on a CPU-only trace with the default categories."""
    planes = _events(logdir, cats)
    if planes is None:
        return None
    best = 0.0
    for evs in planes.values():
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in evs)
        busy, end = 0.0, float("-inf")
        for lo, hi in spans:
            if hi <= end:
                continue
            busy += hi - max(lo, end)
            end = hi
        best = max(best, busy)
    return best / 1e3
