"""The port's profiler (``tony_tpu_torch.profiler``) on the CPU:
``ServeProfiler``'s arm, poll and finish protocol (the reference's,
``tony_tpu/profiler/profiler.py``) writing a ``torch.profiler`` trace,
``StepProfiler``'s trigger file, and the Chrome-trace reader's per-event
totals and busy time on a small trace, with the CPU's host operators as
the events (a CPU trace has no kernel events, so the default device
categories read "not measured")."""

import glob
import json
import os

import pytest
import torch

from tony_tpu_torch.profiler import (ServeProfiler, StepProfiler,
                                     device_busy_ms, op_totals_ms,
                                     per_plane_op_totals_ms, trace,
                                     write_trigger)

HOST = ("cpu_op",)


def _work():
    x = torch.randn(64, 64)
    for _ in range(3):
        x = torch.mm(x, x).relu()
    return x


def _trace_files(logdir):
    return glob.glob(os.path.join(logdir, "*.pt.trace.json"))


def test_serve_profiler_arm_poll_finish(tmp_path):
    prof = ServeProfiler(default_logdir=str(tmp_path))
    assert not prof.busy
    prof.poll()  # idle: nothing armed, nothing happens
    logdir = prof.request(2)
    with pytest.raises(RuntimeError, match="already"):
        prof.request(1)
    prof.poll()  # starts the trace
    assert prof.status()["active"] and prof.status()["steps_left"] == 2
    _work()
    prof.poll()
    prof.poll()  # the second step: stops and writes the file
    st = prof.status()
    assert not st["active"] and st["captures"] == 1
    assert st["last_logdir"] == logdir and st["last_error"] == ""
    (path,) = _trace_files(logdir)
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    prof.close()
    with pytest.raises(RuntimeError, match="closed"):
        prof.request(1)
    with pytest.raises(ValueError):
        ServeProfiler(str(tmp_path)).request(0)


def test_serve_profiler_close_finalizes_a_running_capture(tmp_path):
    prof = ServeProfiler(default_logdir=str(tmp_path))
    logdir = prof.request(50)
    prof.poll()
    _work()
    prof.close()
    assert prof.status()["captures"] == 1 and not prof.busy
    assert _trace_files(logdir)


def test_step_profiler_trigger_file(tmp_path):
    workdir = str(tmp_path)
    sp = StepProfiler(workdir=workdir, task_id="worker:0")
    assert not sp.poll()
    logdir = str(tmp_path / "traces")
    write_trigger(workdir, num_steps=2, logdir=logdir, task_id="worker:0")
    assert sp.poll()  # consumed: the trace runs for the next 2 steps
    _work()
    assert sp.poll()
    _work()
    assert not sp.poll()
    assert sp.captures == 1 and _trace_files(logdir)


def test_chrome_trace_reader_on_a_torch_profiler_trace(tmp_path):
    logdir = str(tmp_path)
    with trace(logdir):
        _work()
    totals = op_totals_ms(logdir, HOST)
    assert totals["aten::mm"] > 0 and totals["aten::relu"] > 0
    per_plane = per_plane_op_totals_ms(logdir, HOST)
    assert sum(sum(p.values()) for p in per_plane.values()) == \
        pytest.approx(sum(totals.values()))
    busy = device_busy_ms(logdir, HOST)
    # nested operators overlap: the union is at most the sum, at least
    # the longest operator
    assert max(totals.values()) <= busy + 1e-9
    assert busy <= sum(totals.values()) + 1e-9
    # no kernel ran on this CPU trace: device busy time is not measured
    assert device_busy_ms(logdir) is None and op_totals_ms(logdir) is None


def test_chrome_trace_reader_counts_overlapping_streams_once(tmp_path):
    events = [{"ph": "X", "cat": "kernel", "name": "a", "pid": 0, "tid": 7,
               "ts": 0.0, "dur": 10.0},
              {"ph": "X", "cat": "kernel", "name": "b", "pid": 0, "tid": 8,
               "ts": 5.0, "dur": 10.0},
              {"ph": "X", "cat": "kernel", "name": "a", "pid": 1, "tid": 7,
               "ts": 0.0, "dur": 4.0},
              {"ph": "X", "cat": "cpu_op", "name": "host", "pid": 99,
               "tid": 1, "ts": 0.0, "dur": 100.0}]
    with open(tmp_path / "x.pt.trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    (tmp_path / "torn.pt.trace.json").write_text('{"traceEvents": [')
    assert op_totals_ms(str(tmp_path)) == {"a": 0.014, "b": 0.01}
    assert per_plane_op_totals_ms(str(tmp_path)) == {
        "/device:GPU:0": {"a": 0.01, "b": 0.01},
        "/device:GPU:1": {"a": 0.004}}
    assert device_busy_ms(str(tmp_path)) == pytest.approx(0.015)
