"""The port's copies of the JAX package's job-history, journal and
background-loop modules, held against the reference: history files and
the ticket journal written by one package read back in the other (the
portal's layout, a gateway's ``--history`` job included), the liveness
watchdog's expiry, ``MetricsStore``, and ``AutotuneController``'s
decisions on the same sample streams (the port reads captured graph keys
where the reference reads compiled programs)."""

import os
import threading
import time

import pytest

from torch_parity import build_pair, tokens
from tony_tpu import events as j_events
from tony_tpu.coordinator import liveness as j_liveness
from tony_tpu.events import history as j_history
from tony_tpu.events import mover as j_mover
from tony_tpu.gateway import journal as j_journal
from tony_tpu.metrics import sampler as j_sampler
from tony_tpu.serve import autotune as j_autotune
from tony_tpu_torch import events as t_events
from tony_tpu_torch.coordinator import liveness as t_liveness
from tony_tpu_torch.events import history as t_history
from tony_tpu_torch.events import mover as t_mover
from tony_tpu_torch.gateway import Gateway, GatewayHistory, GenRequest
from tony_tpu_torch.gateway import journal as t_journal
from tony_tpu_torch.metrics import sampler as t_sampler
from tony_tpu_torch.serve import Server
from tony_tpu_torch.serve import autotune as t_autotune

PAIRS = [(t_events, t_history, j_history), (j_events, j_history, t_history)]


def _write_job(ev, root, app):
    h = ev.EventHandler(root, app, user="alice").start()
    h.emit(ev.application_inited(app, 2, "host0"))
    h.emit(ev.task_started("worker", 0, "host0"))
    h.emit(ev.task_finished("worker", 0, "FINISHED", {"rss": 1.0}))
    h.emit(ev.application_finished(app, "SUCCEEDED", 0))
    return h.stop("SUCCEEDED")


@pytest.mark.parametrize("writer,_,reader", PAIRS,
                         ids=["port-writes", "reference-writes"])
def test_history_written_by_one_package_reads_in_the_other(
        tmp_path, writer, _, reader):
    root = str(tmp_path)
    final = _write_job(writer, root, "application_abc123")
    events = reader.parse_events(final)
    assert [e.type.name for e in events] == [
        "APPLICATION_INITED", "TASK_STARTED", "TASK_FINISHED",
        "APPLICATION_FINISHED"]
    assert events[2].payload["metrics"] == {"rss": 1.0}
    meta = reader.parse_metadata(os.path.dirname(final))
    assert (meta.user, meta.status) == ("alice", "SUCCEEDED")
    assert [j["app_id"] for j in reader.list_jobs(root)] == \
        ["application_abc123"]


def test_history_names_and_mover_match_reference(tmp_path):
    for h in (t_history, j_history):
        name = h.finished_name("application_1_2", 100, 200, "bob", "FAILED")
        assert t_history.parse_history_name(name) == \
            j_history.parse_history_name(name)
        ip = h.inprogress_name("application_9", 55)
        assert t_history.parse_history_name(ip) == \
            j_history.parse_history_name(ip)
    moved = []
    for mover, ev in ((t_mover, t_events), (j_mover, j_events)):
        root = str(tmp_path / mover.__name__)
        done = ev.EventHandler(root, "application_done")
        done.start()
        done.stop("SUCCEEDED")
        ev.EventHandler(root, "application_running").start()
        moved.append([os.path.basename(p)
                      for p in mover.move_finished_jobs(root)])
    assert moved[0] == moved[1] == ["application_done"]


REQ = {"prompt": [1, 2, 3], "max_new_tokens": 8, "temperature": 0.0}


@pytest.mark.parametrize("writer,reader", [(t_journal, j_journal),
                                           (j_journal, t_journal)],
                         ids=["port-writes", "reference-writes"])
def test_journal_written_by_one_package_replays_in_the_other(
        tmp_path, writer, reader):
    j = writer.TicketJournal(str(tmp_path / "journal.ndjson"))
    j.admit("r1", REQ, 123.0)
    j.route("r1", 1, "local")
    j.emit("r1", 3)
    j.emit("r1", 7)
    j.admit("r2", REQ, 124.0)
    j.done("r2")
    j.admit("r3", REQ, 125.0)
    j.shed("r3", 503)
    j.close()
    entries = reader.replay(j.path)
    assert {rid: e.live for rid, e in entries.items()} == \
        {"r1": True, "r2": False, "r3": False}
    e = entries["r1"]
    assert (e.request, e.replica, e.host, e.offset, e.t_admit) == \
        (REQ, 1, "local", 7, 123.0)
    assert reader.find_latest(str(tmp_path)) is None  # not a history dir


def test_gateway_history_job_reads_in_the_reference(tmp_path):
    """``--history``: the port's gateway leaves a job the reference's
    history reader (the portal's) lists, with its event log and one
    metrics row a request."""
    _, _, tm = build_pair(9)
    root = str(tmp_path)
    hist = GatewayHistory(root, n_replicas=2)
    gw = Gateway([Server(tm, batch_size=2, eos_id=-1, device="cpu",
                         min_bucket=8) for _ in range(2)],
                 history=hist).start()
    try:
        for i in range(3):
            gw.submit(GenRequest(tokens(40 + i, 5).tolist(), 4,
                                 id=f"h{i}")).result(timeout=60)
    finally:
        gw.drain(timeout=60)
    jobs = j_history.list_jobs(root)
    assert [j["app_id"] for j in jobs] == [hist.app_id]
    logs = [f for f in os.listdir(hist.job_dir) if f.endswith(".jhist.jsonl")
            or f.endswith(".inprogress")]
    events = j_history.parse_events(os.path.join(hist.job_dir, logs[0]))
    assert [e.type.name for e in events] == ["APPLICATION_INITED",
                                             "APPLICATION_FINISHED"]
    with open(os.path.join(hist.job_dir, "metrics", "requests.jsonl")) as f:
        assert len(f.read().splitlines()) == 3


@pytest.mark.parametrize("mod", [t_liveness, j_liveness],
                         ids=["port", "reference"])
def test_liveness_monitor_expires_the_silent_task(mod):
    expired = []
    fired = threading.Event()

    def on_expired(task):
        expired.append(task)
        fired.set()

    mon = mod.LivenessMonitor(20, 3, on_expired).start()
    try:
        mon.register("alive")
        mon.register("silent")
        mon.register("gone")
        mon.unregister("gone")
        deadline = time.monotonic() + 5
        while not fired.is_set() and time.monotonic() < deadline:
            mon.ping("alive")
            time.sleep(0.005)
    finally:
        mon.stop()
    assert expired == ["silent"]
    assert mon.expiry_s == j_liveness._expiry_s(20, 3) == 0.06


@pytest.mark.parametrize("mod", [t_sampler, j_sampler],
                         ids=["port", "reference"])
def test_metrics_store_and_rss(mod):
    store = mod.MetricsStore()
    assert store.update_metrics("gateway:replica-0", {"a": 1, "b": 2.5})
    assert store.get_metrics("gateway:replica-0") == {"a": 1.0, "b": 2.5}
    assert store.get_metrics("nobody") == {}
    assert mod.process_tree_rss_bytes(os.getpid()) > 0
    assert mod.process_tree_rss_bytes(2 ** 22 + 12345) == 0


class _Timeline:
    def __init__(self):
        self.summ = {}

    def summary(self):
        return {k: dict(v) for k, v in self.summ.items()}


class _Graphs:
    def __init__(self, keys):
        self.entries = dict.fromkeys(keys)


class _Engine:
    """The attribute surface the controller reads and writes; the
    reference checks ``_compiled`` programs, the port ``graphs`` keys."""

    def __init__(self, keys):
        self.chunk_steps = 2
        self.speculate_k = 4
        self.prefill_chunk = 0
        self.min_bucket = 16
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.timeline = _Timeline()
        self._compiled = set(keys)
        self.graphs = _Graphs(keys)

    def feed(self, kind, count, ms, useful, padding, overshoot, rejected,
             tokens):
        a = self.timeline.summ.setdefault(kind, {
            "count": 0, "ms": 0.0, "compile_ms": 0.0, "tokens": 0,
            "useful_ms": 0.0, "padding_ms": 0.0, "overshoot_ms": 0.0,
            "rejected_ms": 0.0})
        for k, v in (("count", count), ("ms", ms), ("useful_ms", useful),
                     ("padding_ms", padding), ("overshoot_ms", overshoot),
                     ("rejected_ms", rejected), ("tokens", tokens)):
            a[k] += v


# one tick's traffic: healthy decode (grow the chunk), then heavy
# overshoot (shrink it), then verify rounds rejecting most drafts
TICKS = [("decode", 8, 80.0, 76.0, 4.0, 0.0, 0.0, 16)] * 4 \
    + [("decode", 8, 80.0, 30.0, 2.0, 48.0, 0.0, 8)] * 4 \
    + [("verify", 8, 90.0, 20.0, 5.0, 0.0, 65.0, 10)] * 4


def _decisions(mod):
    keys = {("decode", 4, 2), ("decode", 8, 2), ("verify", 5, 0, 2)}
    ctl = mod.AutotuneController(chunk_bounds=(1, 16), spec_bounds=(0, 8),
                                 prefill_bounds=(0, 0), hold_ticks=1,
                                 cooldown_ticks=0, min_dispatches=2)
    srv = _Engine(keys)
    for tick in TICKS:
        srv.feed(*tick)
        ctl.tick([(0, srv)])
    rows = [{k: v for k, v in row.items() if k != "t"}
            for row in ctl.recent]
    snap = {k: v for k, v in ctl.snapshot().items() if k != "recent"}
    return rows, snap, (srv.chunk_steps, srv.speculate_k)


def test_autotune_decisions_match_reference():
    rows, snap, knobs = _decisions(t_autotune)
    assert (rows, snap, knobs) == _decisions(j_autotune)
    assert {r["knob"] for r in rows} >= {"chunk_steps"}
    assert any(r["new_compile"] for r in rows) \
        and not all(r["new_compile"] for r in rows)
