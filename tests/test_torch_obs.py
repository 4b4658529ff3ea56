"""The port's copies of ``tony_tpu/obs`` held against the reference
modules on the same inputs: Prometheus rendering (and ``/metrics`` over
one frozen gateway snapshot, apart from the build-info labels and the
host block's device family), request-trace spans and their Chrome
export, the dispatch-timeline summary, alert rules firing and resolving,
the goodput ledger and its fleet merge, and the cost model. Also the
port ``Server``'s own ``goodput()``: the reference's bucket keys, with
fractions that sum to at most 1, and the card table's detection."""

import pytest
import torch

from torch_parity import build_pair, tokens
from tony_tpu.obs import alerts as j_alerts
from tony_tpu.obs import export as j_export
from tony_tpu.obs import goodput as j_goodput
from tony_tpu.obs import prom as j_prom
from tony_tpu.obs import timeline as j_timeline
from tony_tpu.obs import trace as j_trace
from tony_tpu.serve import Request as JaxRequest
from tony_tpu.serve import Server as JaxServer
from tony_tpu_torch.gateway import Gateway, GenRequest
from tony_tpu_torch.obs import alerts as t_alerts
from tony_tpu_torch.obs import export as t_export
from tony_tpu_torch.obs import goodput as t_goodput
from tony_tpu_torch.obs import prom as t_prom
from tony_tpu_torch.obs import timeline as t_timeline
from tony_tpu_torch.obs import trace as t_trace
from tony_tpu_torch.serve import Request, Server

EOS = (9, 33, 71)
SERVE = dict(min_bucket=8, kv_page_size=8, prefix_cache_mb=4.0)


@pytest.fixture(scope="module")
def models():
    return build_pair(9)


def _prom_doc(prom):
    fam = prom.MetricFamily("tony_x_total", "counter", "x \\ help")
    fam.add(3, {"replica": "0", "kind": 'a"b\n'})
    fam.add(2.5e-7, {"replica": "1"})
    fam.add(float("inf"))
    hist = prom.Histogram()
    for v in (0.001, 0.02, 0.02, 0.7, 3.0, 1e4):
        hist.observe(v)
    empty = prom.MetricFamily("tony_empty", "gauge", "never rendered")
    snap = hist.snapshot()
    return prom.render([fam, hist.family("tony_h_seconds", "h",
                                         {"tier": "batch"}), empty]), \
        snap, prom.hist_over_edge(snap, 0.5)


def test_prometheus_rendering_matches_reference():
    assert _prom_doc(t_prom) == _prom_doc(j_prom)


def _trace_doc(trace):
    tr = trace.RequestTrace("req-1", t0=100.0)
    tr._wall0 = 0.0  # the wall clock's anchor, read at construction
    tr.begin_attempt(0, 0, 100.1)
    tr.add("queue_wait", 100.1, 100.2)
    tr.add("decode", 100.2, 100.4, tokens=3)
    tr.end_attempt(100.5, outcome="failed")
    tr.begin_attempt(1, 1, 100.6)
    tr.add("prefill", 100.6, 100.7, bucket=16)
    tr.finish(101.0, finish_reason="length")
    buf = trace.TraceBuffer(capacity=2)
    for rid in ("a", "b", "req-1"):
        t = tr if rid == "req-1" else trace.RequestTrace(rid, t0=99.0)
        if rid != "req-1":
            t.finish(99.5)
        buf.put(t)
    return (tr.to_chrome(), trace.check_invariants(tr), buf.ids(),
            buf.summaries())


def test_trace_spans_match_reference():
    assert _trace_doc(t_trace) == _trace_doc(j_trace)


def _records(tl):
    R = tl.DispatchRecord
    return [
        R("prefill", 1.0, 12.0, 1, 16, 1, True, request_id=0, work=16,
          fed=5, est_bytes=1e6, est_flops=2e6),
        R("prefill", 1.1, 2.0, 2, 16, 1, False, request_id=1, work=16,
          fed=9, est_bytes=1e6, est_flops=2e6),
        R("cow_admit", 1.2, 0.3, 2, 0, 1, False, request_id=2, work=1,
          fed=1, est_bytes=512.0, est_flops=128.0),
        R("decode", 1.3, 40.0, 2, 8, 0, True, work=16, fed=0),
        R("decode", 1.4, 5.0, 2, 8, 13, False, work=16, fed=13,
          tags={"frozen": 3}, est_bytes=4e7, est_flops=9e7),
        R("verify", 1.5, 6.0, 2, 5, 7, False, work=26, fed=11,
          rejected=4, est_bytes=5e7, est_flops=1e8),
        R("prefill_chunk", 1.6, 3.0, 1, 32, 0, False, work=32, fed=32,
          est_bytes=2e6, est_flops=4e6),
    ]


def _timeline_doc(tl):
    timeline = tl.DispatchTimeline(capacity=4)
    for rec in _records(tl):
        timeline.record(rec)
    new, cursor = timeline.take_new(2)
    return (timeline.summary(), [tl.record_doc(r) for r in new], cursor,
            timeline.seq)


def test_timeline_summary_matches_reference():
    assert _timeline_doc(t_timeline) == _timeline_doc(j_timeline)
    # a record written by one package reads back in the other
    for rec in _records(t_timeline):
        doc = t_timeline.record_doc(rec)
        assert j_timeline.record_doc(j_timeline.record_from_doc(doc)) == doc


SIGNALS = [
    {"oldest_wait_s": 9.0, "depth": 3, "kv_pages_total": 100,
     "kv_pages_free": 5, "kv_pages_reserved": 2, "active_slots": 2},
    {"oldest_wait_s": 9.5, "depth": 4, "kv_pages_total": 100,
     "kv_pages_free": 4, "kv_pages_reserved": 0, "active_slots": 2,
     "shed_events": 70},
    {"oldest_wait_s": 0.0, "depth": 0, "kv_pages_total": 100,
     "kv_pages_free": 90, "kv_pages_reserved": 0, "active_slots": 0},
    {"oldest_wait_s": 0.0, "depth": 0, "kv_pages_total": 100,
     "kv_pages_free": 90, "kv_pages_reserved": 0, "active_slots": 0},
    {"oldest_wait_s": 0.0, "depth": 0},
]


def _alert_doc(alerts):
    bus = alerts.AlertBus(alerts.default_rules({"queue_wait_s": 5.0,
                                                "kv_free_frac": 0.15}))
    rows = []
    for i, sig in enumerate(SIGNALS):
        rows.append([e.to_row() for e in bus.evaluate(sig, t_wall=10.0 + i)])
    return rows, bus.snapshot()


def test_alert_rules_fire_and_resolve_like_reference():
    rows, snap = _alert_doc(t_alerts)
    assert (rows, snap) == _alert_doc(j_alerts)
    assert any(r["state"] == "firing" for tick in rows for r in tick)
    assert any(r["state"] == "resolved" for tick in rows for r in tick)


def _ledger_doc(goodput, tl):
    timeline = tl.DispatchTimeline()
    for rec in _records(tl):
        timeline.record(rec)
    summ = timeline.summary()
    led = goodput.ledger(summ, 400.0, hbm_gbps=3350.0, peak_flops=989e12)
    short = goodput.ledger(summ, 20.0)
    return led, short, goodput.merge_ledgers([led, short, None])


def test_goodput_ledger_and_merge_match_reference():
    led, short, merged = _ledger_doc(t_goodput, t_timeline)
    assert (led, short, merged) == _ledger_doc(j_goodput, j_timeline)
    for doc in (led, short, merged):
        assert sum(doc["buckets"].values()) <= 1.0


def _cost_doc(goodput):
    cm = goodput.CostModel(param_bytes=3_087_428_608,
                           param_count=1_543_714_304,
                           kv_token_bytes=28672.0, n_heads=12,
                           head_dim=128, vocab_size=151936,
                           hbm_gbps=3350.0, peak_flops=989e12)
    est = [cm.decode(8, 8, 1024), cm.verify(9, 8, 2048),
           cm.prefill(512, 64, 1024), cm.prefill(16), cm.hit_admit(1 << 20),
           cm.cow_admit(1 << 16), cm.host_move(123.0)]
    return est, [cm.utilization(b, f, 3.5) for b, f in est[:4]], \
        cm.utilization(1.0, 1.0, 0.0)


def test_cost_model_matches_reference():
    assert _cost_doc(t_goodput) == _cost_doc(j_goodput)


def test_card_table_detection(monkeypatch):
    """The H100 rows, the PCIe part's own, and 0 ("no estimate") for a
    card the table does not list or no card at all."""
    cases = {"NVIDIA H100 80GB HBM3": (3350.0, 989e12),
             "NVIDIA H100 PCIe": (2000.0, 756e12),
             "NVIDIA A10G": (0.0, 0.0), None: (0.0, 0.0)}
    monkeypatch.delenv("TONY_HBM_GBPS", raising=False)
    for name, want in cases.items():
        monkeypatch.setattr(torch.cuda, "is_available",
                            lambda n=name: n is not None)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda *a, n=name: n)
        monkeypatch.setattr(t_goodput, "_DISCOVERED_NAMES", None)
        assert (t_goodput.detect_hbm_gbps(),
                t_goodput.detect_peak_flops()) == want
    monkeypatch.setenv("TONY_HBM_GBPS", "1234")
    assert t_goodput.detect_hbm_gbps() == 1234.0


def _mix():
    pre = tokens(10, 12).tolist()
    return [(pre + tokens(11, 3).tolist(), 10), (tokens(20, 4).tolist(), 8),
            (pre + tokens(12, 5).tolist(), 14), (tokens(21, 9).tolist(), 1),
            (pre + tokens(11, 3).tolist(), 6)]


@pytest.mark.parametrize("paged", [True, False])
def test_server_goodput_has_the_reference_buckets(models, paged):
    jm, jp, tm = models
    kw = dict(SERVE) if paged else {"min_bucket": 8}
    docs = []
    for srv, req in ((JaxServer(jm, jp, batch_size=2, eos_id=EOS,
                                paged=paged, **kw), JaxRequest),
                     (Server(tm, batch_size=2, eos_id=EOS, paged=paged,
                             device="cpu", **kw), Request)):
        list(srv.run([req(list(p), n, id=i)
                      for i, (p, n) in enumerate(_mix())]))
        docs.append((srv.goodput(), srv.timeline.summary()))
    (jg, js), (tg, ts) = docs
    assert set(tg) == set(jg)
    assert set(tg["buckets"]) == set(jg["buckets"])
    assert 0.0 < sum(tg["buckets"].values()) <= 1.0
    # the same dispatches of the same kinds, landing the same tokens
    assert {k: (v["count"], v["tokens"], v["fed"], v["work"])
            for k, v in ts.items()} == \
        {k: (v["count"], v["tokens"], v["fed"], v["work"])
         for k, v in js.items()}
    off = Server(tm, batch_size=2, paged=paged, device="cpu",
                 timeline=False, **kw)
    assert off.goodput() is None and off.timeline is None


def test_prometheus_text_matches_reference_on_one_snapshot(models):
    """``/metrics`` of a port gateway that served traffic, rendered by
    both packages' exporters from one frozen snapshot: every family,
    type and sample equal but for ``tony_build_info`` (the port reports
    torch and CUDA, not jax) and the host block's device family (the
    port's is card memory)."""
    _, _, tm = models
    gw = Gateway([Server(tm, batch_size=2, eos_id=EOS, device="cpu",
                         **SERVE) for _ in range(2)]).start()
    try:
        tickets = [gw.submit(GenRequest(list(p), n, id=f"r{i}"))
                   for i, (p, n) in enumerate(_mix())]
        for t in tickets:
            t.result(timeout=60.0)
        snap = gw.snapshot()
        gw.snapshot = lambda: snap
        docs = [exp.prometheus_text(gw) for exp in (t_export, j_export)]
    finally:
        gw.drain(timeout=60.0)

    def lines(doc):
        # a HELP line by its family's name: the copy's help prose drops
        # the reference's issue-tracker references
        return [" ".join(ln.split()[:3]) if ln.startswith("# HELP") else ln
                for ln in doc.splitlines()
                if "tony_build_info" not in ln
                and "tony_host_gpu_memory" not in ln
                and "tony_host_tpu" not in ln]

    assert lines(docs[0]) == lines(docs[1])
    assert 'torch="%s"' % torch.__version__ in docs[0]
    assert "tony_goodput_fraction" in docs[0]
