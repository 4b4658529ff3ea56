"""Gateway -> Prometheus assembly: the ``GET /metrics`` document.

The PyTorch port's copy of ``tony_tpu/obs/export.py``.

Everything is derived from ``Gateway.snapshot()`` — the same payload
``/stats`` serves — plus the gateway's lifetime latency histograms, so
the two surfaces can never disagree: a scraper's counter and a human's
JSON read the same numbers. Duck-typed against the gateway (no import
of ``tony_tpu_torch.gateway`` — this module sits below it).

Naming follows the Prometheus conventions: ``_total`` counters,
base-unit seconds/bytes, one ``replica`` label for per-replica series
(aggregate with ``sum by ()``), a ``kind`` label on the dispatch
timeline families, and a state-info family
(``tony_replica_state{state="..."} 1``) for the breaker's string
state. The full reference table lives in docs/OBSERVABILITY.md.
"""

from __future__ import annotations

from tony_tpu_torch.obs.prom import MetricFamily, render

_BUILD_INFO: dict | None = None


def build_info_labels() -> dict:
    """The ``tony_build_info`` label set, computed ONCE per process
    (the commit lookup shells out to git): package version, torch
    version, the CUDA version torch was built for, and the git commit —
    so a scrape can correlate a regression with the deploy that shipped
    it. "unknown" where a deployed wheel has no git checkout; "none"
    for a CPU-only torch."""
    global _BUILD_INFO
    if _BUILD_INFO is None:
        import torch

        from tony_tpu_torch.version import __version__, _git

        _BUILD_INFO = {
            "version": __version__,
            "torch": torch.__version__,
            "cuda": torch.version.cuda or "none",
            "commit": _git("rev-parse", "--short", "HEAD"),
        }
    return _BUILD_INFO

# flat per-replica engine counters exported with a replica label;
# everything else in the replica stats row is either covered by an
# explicit family below or a string (state)
_REPLICA_COUNTERS = (
    ("prefills", "tony_engine_prefills_total",
     "Prefill dispatches run (exact prefix hits skip one)"),
    ("decode_steps", "tony_engine_decode_steps_total",
     "Decode dispatch depth, summed (chunk k / verify window)"),
    ("dispatches", "tony_engine_dispatches_total",
     "Decode dispatches (chunk + verify)"),
    ("frozen_steps", "tony_engine_frozen_steps_total",
     "Decode/verify positions a finished slot spent frozen "
     "(in-dispatch EOS re-emits: no KV writes, padding not overshoot)"),
    ("wasted_steps", "tony_engine_wasted_steps_total",
     "Per-slot token positions decoded and thrown away"),
    ("spec_rounds", "tony_engine_spec_rounds_total",
     "Speculative verify dispatches run"),
    ("spec_drafted", "tony_engine_spec_drafted_total",
     "Draft tokens sent through verify"),
    ("spec_accepted", "tony_engine_spec_accepted_total",
     "Draft tokens accepted by verify"),
    ("prefix_lookups", "tony_engine_prefix_lookups_total",
     "Admissions that consulted the prefix store"),
    ("prefix_hits", "tony_engine_prefix_hits_total",
     "Admissions seeded >= 1 cached prompt token"),
    ("prefix_hit_tokens", "tony_engine_prefix_hit_tokens_total",
     "Prompt tokens seeded from the prefix store"),
    ("prefill_tokens_saved", "tony_engine_prefill_tokens_saved_total",
     "Bucketed prefill work skipped via prefix reuse"),
    ("prefill_chunk_dispatches", "tony_engine_prefill_chunks_total",
     "Chunked-prefill dispatches run (budget-bounded prompt windows)"),
    ("prefill_chunked_requests",
     "tony_engine_prefill_chunked_requests_total",
     "Requests whose prompt prefilled in more than one chunk"),
    ("handoffs_out", "tony_engine_handoffs_out_total",
     "Prefill-pool requests handed off as page lists"),
    ("handoffs_in", "tony_engine_handoffs_in_total",
     "Handoff payloads admitted by this (decode-pool) replica"),
    ("migrations_out", "tony_engine_migrations_out_total",
     "Live sessions frozen and extracted off this replica mid-stream"),
    ("migrations_in", "tony_engine_migrations_in_total",
     "Migrated sessions adopted into a decode slot on this replica"),
    ("migrations_local", "tony_engine_migrations_local_total",
     "Shared-pool owner swaps (both sides count one)"),
    ("migrations_remote", "tony_engine_migrations_remote_total",
     "Cross-host wire migrations (both sides count one)"),
    ("migrate_pages_moved", "tony_engine_migrate_pages_moved_total",
     "KV pages physically copied by migrations (wire path)"),
    ("migrate_bytes_avoided", "tony_engine_migrate_bytes_avoided_total",
     "KV bytes an owner swap kept in place instead of copying"),
    ("migrate_bytes_wire", "tony_engine_migrate_bytes_wire_total",
     "KV bytes that actually crossed the wire in migration payloads"),
    ("migrate_delta_in", "tony_engine_migrate_delta_in_total",
     "Wire adoptions that rebuilt their prefix from local radix pages"),
    ("migrate_freeze_resume_ms",
     "tony_engine_migrate_freeze_resume_ms_total",
     "Milliseconds sessions spent frozen between extract and adopt"),
    ("kv_host_spills", "tony_kv_host_spills_total",
     "Prefix-store entries spilled device->host into the page tier"),
    ("kv_host_page_ins", "tony_kv_host_page_ins_total",
     "Host-tier entries restored host->device on a prefix hit"),
    ("kv_host_spill_bytes", "tony_kv_host_spill_bytes_total",
     "Bytes copied device->host by tier spills"),
    ("kv_host_page_in_bytes", "tony_kv_host_page_in_bytes_total",
     "Bytes restored host->device by tier page-ins"),
    ("kv_host_evictions", "tony_kv_host_evictions_total",
     "Host-tier entries evicted by its own byte budget"),
    ("completed", "tony_replica_completed_total",
     "Requests delivered by this replica"),
    ("shed", "tony_replica_shed_total",
     "Requests shed charged to this replica"),
    ("enqueued", "tony_replica_enqueued_total",
     "Tickets ever enqueued on this replica (failover re-enqueues "
     "included)"),
    ("failures", "tony_replica_breaker_failures_total",
     "Circuit-breaker trips (lifetime)"),
    ("probes", "tony_replica_probes_total",
     "Breaker probe generations attempted"),
    ("rejoins", "tony_replica_rejoins_total",
     "Probe successes that rejoined the routing set"),
)

_REPLICA_GAUGES = (
    ("queued", "tony_replica_queued", "Tickets waiting in this replica's queue"),
    ("oldest_wait_s", "tony_replica_queue_oldest_wait_seconds",
     "Age of the oldest ticket waiting in this replica's queue"),
    ("enqueue_rate_per_s", "tony_replica_enqueue_rate",
     "Recent enqueues per second (10 s window)"),
    ("active_slots", "tony_replica_active_slots",
     "Cache slots currently decoding"),
    ("batch_size", "tony_replica_slots", "Cache slots total"),
    ("outstanding_tokens", "tony_replica_outstanding_tokens",
     "Token-cost estimate of queued + in-flight work"),
    ("heartbeat_age_s", "tony_replica_heartbeat_age_seconds",
     "Seconds since the replica thread's last heartbeat"),
    ("consecutive_failures", "tony_replica_consecutive_failures",
     "Breaker failure streak since the last delivered result"),
    ("epoch", "tony_replica_epoch", "Fencing epoch (bumps per failure)"),
    ("prefix_entries", "tony_prefix_entries", "Prefix store entries resident"),
    ("prefix_bytes", "tony_prefix_bytes", "Prefix store bytes resident"),
    ("prefix_budget_bytes", "tony_prefix_budget_bytes",
     "Prefix store byte budget"),
    # paged-KV utilization (absent on unpaged replicas): the
    # fixed-shape-waste sensor — resident bytes track allocated pages,
    # tokens_resident what actually lives in them
    ("kv_pages_total", "tony_kv_pages_total_pages", "KV page pool size"),
    ("kv_pages_used", "tony_kv_pages_used", "KV pages allocated"),
    ("kv_pages_free", "tony_kv_pages_free", "KV pages on the free list"),
    ("kv_pages_reserved", "tony_kv_pages_reserved",
     "KV pages reserved by admitted requests, not yet allocated"),
    ("kv_cow_shared", "tony_kv_cow_shared_pages",
     "KV pages held by more than one owner (copy-on-write sharing)"),
    ("kv_cow_forks", "tony_kv_cow_forks",
     "Copy-on-write page forks performed (lifetime)"),
    ("kv_page_size", "tony_kv_page_size_tokens", "Tokens per KV page"),
    ("kv_bytes_resident", "tony_kv_bytes_resident",
     "Bytes of KV pool resident (allocated pages x page bytes)"),
    ("kv_tokens_resident", "tony_kv_tokens_resident",
     "Tokens resident in allocated pages (live slots + prefix store)"),
    # host-RAM page tier (absent with --kv-host-mb 0)
    ("kv_host_entries", "tony_kv_host_entries",
     "Host page-tier entries resident"),
    ("kv_host_bytes", "tony_kv_host_bytes",
     "Host page-tier bytes resident"),
    ("kv_host_budget_bytes", "tony_kv_host_budget_bytes",
     "Host page-tier byte budget (--kv-host-mb)"),
    ("kv_host_tokens", "tony_kv_host_tokens",
     "Tokens covered by host page-tier entries"),
)

# the per-replica ``transport`` block (remote replicas only —
# gateway/remote.RemoteServer): where the network between the gateway
# and a replica agent spends its time. The rtt field arrives in ms
# (human units on /stats); the exposition converts to base seconds.
_TRANSPORT_GAUGES = (
    ("heartbeat_age_s", "tony_transport_heartbeat_age_seconds",
     "Seconds since the last successful agent heartbeat"),
    ("lease_s", "tony_transport_lease_seconds",
     "The lease horizon: heartbeats missed this long fail the replica"),
    # the clock-offset model: ms deliberately — the value
    # is a CORRECTION term read next to span timestamps (which render
    # in ms), not a duration to rate()
    ("clock_offset_ms", "tony_transport_clock_offset_ms",
     "Agent-minus-gateway monotonic clock offset (RTT-midpoint EWMA) "
     "applied to remote dispatch spans"),
    ("clock_offset_unc_ms", "tony_transport_clock_offset_unc_ms",
     "Half-RTT EWMA: the honest error bar on the clock offset"),
)

# the obs-pull channel (remote replicas): the surface that
# distinguishes an idle remote replica from an UNOBSERVED one
_OBS_GAUGES = (
    ("lag_s", "tony_transport_obs_lag_seconds",
     "Seconds since the last successful observability pull from the "
     "agent (absent until one lands)"),
    ("cursor", "tony_transport_obs_cursor",
     "Dispatch-timeline cursor position on the agent's obs channel"),
)

_OBS_COUNTERS = (
    ("pulls", "tony_transport_obs_pulls_total",
     "Successful observability pulls from the agent"),
    ("pull_errors", "tony_transport_obs_pull_errors_total",
     "Observability pulls that failed (the channel degrades to "
     "staleness, never to a replica failure)"),
)

_TRANSPORT_COUNTERS = (
    ("reconnects", "tony_transport_reconnects_total",
     "Stream reconnects (resume-by-offset; not failovers)"),
    ("retries", "tony_transport_retries_total",
     "In-lease connect retries (capped backoff + jitter)"),
    ("connect_errors", "tony_transport_connect_errors_total",
     "Transport-level call failures seen (pre-retry)"),
    ("heartbeat_failures", "tony_transport_heartbeat_failures_total",
     "Heartbeats that failed or found the agent not serving"),
    ("stale_epoch_drops", "tony_transport_stale_epoch_drops_total",
     "Agent responses discarded by the epoch fence"),
    ("lease_expiries", "tony_transport_lease_expiries_total",
     "Lease expiries that declared the agent dead"),
    ("migrate_delta_trims", "tony_transport_migrate_delta_trims_total",
     "Migration payloads delta-trimmed against the target's radix "
     "summary before shipping"),
    ("migrate_delta_fallbacks",
     "tony_transport_migrate_delta_fallbacks_total",
     "Delta payloads the agent refused as stale, re-sent in full"),
)

_SUPERVISION = (
    ("replicas_added", "tony_replicas_added_total",
     "Replicas added at runtime (autoscaler or operator)"),
    ("replicas_removed", "tony_replicas_removed_total",
     "Replicas retired at runtime via zero-loss drain"),
    ("replica_failures", "tony_replica_failures_total",
     "HEALTHY -> BROKEN transitions across the fleet"),
    ("failovers", "tony_failovers_total",
     "Tickets requeued onto another replica"),
    ("retries", "tony_retries_total",
     "Failed engine runs charged to tickets"),
    ("probes", "tony_probes_total", "Breaker probes across the fleet"),
    ("rejoins", "tony_rejoins_total", "Breaker rejoins across the fleet"),
    ("quarantines", "tony_quarantines_total", "Replicas quarantined"),
)

_HISTOGRAMS = (
    ("queue_wait", "tony_request_queue_wait_seconds",
     "Submit-to-slot-admission wait per completed request"),
    ("ttft", "tony_request_ttft_seconds",
     "Time to first token per completed request"),
    ("tpot", "tony_request_tpot_seconds",
     "Mean time per output token after the first, per request"),
    ("e2e", "tony_request_e2e_seconds",
     "Whole-life latency per completed request"),
)


def prometheus_text(gateway) -> str:
    """Render the gateway's observability state as Prometheus text
    exposition (0.0.4). One snapshot() drives everything."""
    snap = gateway.snapshot()
    fams: list[MetricFamily] = []

    def counter(name, help_text, value, labels=None):
        fams.append(MetricFamily(name, "counter", help_text)
                    .add(value, labels))
        return fams[-1]

    def gauge(name, help_text, value, labels=None):
        fams.append(MetricFamily(name, "gauge", help_text)
                    .add(value, labels))
        return fams[-1]

    # info-style build family (value always 1; the labels ARE the
    # data): scrapes can join regressions against deploys
    fams.append(MetricFamily(
        "tony_build_info", "gauge",
        "Build/version info: the labeled series reads 1")
        .add(1, build_info_labels()))
    counter("tony_requests_accepted_total",
            "Requests past the admission gate", snap["accepted"])
    counter("tony_requests_completed_total",
            "Requests finished with a result", snap["completed"])
    shed = MetricFamily("tony_requests_shed_total", "counter",
                        "Requests refused or given up on, by HTTP status")
    for status, n in sorted(snap["shed"].items()):
        shed.add(n, {"status": str(status)})
    if snap["shed"]:
        fams.append(shed)
    counter("tony_tokens_in_total", "Prompt tokens accepted",
            snap["tokens_in"])
    counter("tony_tokens_out_total", "Tokens generated and delivered",
            snap["tokens_out"])

    sup = snap["supervision"]
    for key, name, help_text in _SUPERVISION:
        counter(name, help_text, sup[key])
    gauge("tony_healthy_replicas", "Replicas currently routable",
          sup["healthy_replicas"])
    gauge("tony_replicas", "Replicas configured", sup["replicas"])
    gauge("tony_queue_depth", "Tickets queued across the fleet",
          snap["queued"])
    gauge("tony_queue_max", "Admission queue bound", snap["max_queue"])
    gauge("tony_gateway_ready", "1 while accepting (0 = draining)",
          1 if snap["ready"] else 0)
    bundles = snap.get("bundles") or {}
    if bundles:
        counter("tony_debug_bundles_total",
                "Alert-triggered debug bundles written to the history "
                "job dir (the flight recorder)",
                bundles.get("written", 0))

    # the connection-plane block: the event edge's socket
    # economics — how many streams one loop thread is holding, and
    # what got shed or aborted to keep it that way
    edge = snap.get("edge") or {}
    if edge:
        gauge("tony_edge_threads",
              "Edge threads, FIXED at loop + worker pool "
              "(the denominator of the streams-per-thread claim)",
              edge["threads"])
        gauge("tony_edge_open_connections",
              "Sockets currently open on the edge",
              edge["open_connections"])
        gauge("tony_edge_active_streams",
              "NDJSON token streams currently in flight",
              edge["active_streams"])
        gauge("tony_edge_max_connections",
              "Connection breaker threshold (503 past it)",
              edge["max_connections"])
        gauge("tony_edge_accepts_per_second",
              "Recent connection-accept rate",
              edge["accepts_per_s"])
        gauge("tony_edge_write_buffer_hwm_bytes",
              "High-water mark of any connection's write buffer",
              edge["write_buffer_hwm_bytes"])
        counter("tony_edge_accepts_total",
                "Connections accepted", edge["accepts"])
        counter("tony_edge_requests_total",
                "HTTP requests parsed (keep-alive reuse included)",
                edge["requests"])
        counter("tony_edge_slow_client_aborts_total",
                "Streams aborted by the slow-client policy (write "
                "buffer full past the drain timeout)",
                edge["slow_client_aborts"])
        counter("tony_edge_conn_limit_sheds_total",
                "Connections shed 503 by the connection breaker",
                edge["conn_limit_sheds"])
        counter("tony_edge_client_disconnects_total",
                "Connections the client dropped mid-request",
                edge["client_disconnects"])
        counter("tony_edge_keepalives_sent_total",
                "Stream keepalive frames sent to quiet clients",
                edge["keepalives_sent"])

    # the queue block: the autoscaler's primary sensor,
    # scrapable standalone
    q = snap.get("queue") or {}
    if q:
        gauge("tony_queue_oldest_wait_seconds",
              "Age of the oldest queued ticket, fleet-wide",
              q["oldest_wait_s"])
        gauge("tony_queue_enqueue_rate",
              "Recent enqueues per second, fleet-wide (10 s window)",
              q["enqueue_rate_per_s"])

    # admission tiers: per-tier depth/completed/shed counters and the
    # per-tier queue-wait histogram (the WFQ no-starvation evidence)
    adm = snap.get("admission") or {}
    if adm.get("by_tier"):
        tq = MetricFamily("tony_tier_queued", "gauge",
                          "Tickets queued, by admission tier")
        tc = MetricFamily("tony_tier_completed_total", "counter",
                          "Requests completed, by admission tier")
        ts = MetricFamily("tony_tier_shed_total", "counter",
                          "Requests shed, by admission tier")
        for tier, row in sorted(adm["by_tier"].items()):
            labels = {"tier": tier}
            tq.add(row["queued"], labels)
            tc.add(row["completed"], labels)
            ts.add(row["shed"], labels)
        fams.extend([tq, tc, ts])
    quota = adm.get("quota") or {}
    if quota.get("enabled"):
        gauge("tony_quota_rate_tokens", "Per-tenant token-rate quota",
              quota["rate_tokens_per_s"])
        gauge("tony_quota_tenants", "Tenant buckets tracked",
              quota["tenants"])
        counter("tony_quota_rejections_total",
                "Requests refused 429 for tenant quota breach",
                quota["rejections"])

    # autoscaler (absent on fixed fleets)
    sc = snap.get("scaler")
    if sc:
        gauge("tony_scaler_replicas_min", "Autoscaler fleet floor",
              sc["min_replicas"])
        gauge("tony_scaler_replicas_max", "Autoscaler fleet ceiling",
              sc["max_replicas"])
        gauge("tony_replicas_live", "Replicas live (not retired)",
              sc["replicas_live"])
        counter("tony_scale_ups_total", "Autoscaler scale-up actions",
                sc["scale_ups"])
        counter("tony_scale_downs_total",
                "Autoscaler scale-down actions", sc["scale_downs"])
        counter("tony_scaler_errors_total",
                "Autoscaler tick/action errors", sc["errors"])

    # rebalancer (absent / disabled unless --rebalance)
    rb = snap.get("rebalance")
    if rb and rb.get("enabled"):
        counter("tony_rebalance_moves_total",
                "Sessions live-migrated by the rebalancer",
                rb["moves"])
        counter("tony_rebalance_move_failures_total",
                "Acting ticks that found no migratable session",
                rb["move_failures"])
        counter("tony_rebalance_errors_total",
                "Rebalancer tick/action errors", rb["errors"])
        counter("tony_rebalance_ticks_total",
                "Rebalancer control-loop iterations", rb["ticks"])
        gauge("tony_rebalance_streak",
              "Consecutive skewed ticks toward the next move",
              rb["streak"])

    eng = snap["engine"]
    gauge("tony_engine_active_slots", "Live cache slots, fleet-wide",
          eng["active_slots"])
    gauge("tony_engine_slots", "Cache slots, fleet-wide", eng["slots"])
    gauge("tony_prefix_enabled", "1 when the prefix store is on",
          1 if eng["prefix"]["enabled"] else 0)
    gauge("tony_spec_enabled", "1 when speculative decoding is on",
          1 if eng["spec"]["enabled"] else 0)
    gauge("tony_kv_paged_enabled", "1 when the paged KV cache is on",
          1 if eng.get("kv_pages", {}).get("enabled") else 0)
    gauge("tony_kv_host_enabled",
          "1 when the host-RAM KV page tier is on",
          1 if eng.get("kv_host", {}).get("enabled") else 0)

    # sharded replicas: mesh topology — devices per replica
    # and how many ways the KV pools split on the kv-head axis
    mesh = eng.get("mesh") or {}
    gauge("tony_mesh_enabled",
          "1 when replicas are tensor/expert-sharded over a mesh",
          1 if mesh.get("enabled") else 0)
    if mesh.get("enabled"):
        gauge("tony_mesh_devices", "Devices per sharded replica",
              mesh.get("devices", 1))
        gauge("tony_mesh_kv_shards",
              "KV page-pool shards on the kv-head axis",
              mesh.get("kv_shards", 1))
        gauge("tony_mesh_param_bytes_per_chip",
              "Per-chip parameter residency under the serving "
              "shardings", mesh.get("param_bytes_per_chip", 0))

    # disaggregated prefill/decode: routing + handoff flow
    routing = snap.get("routing") or {}
    gauge("tony_prefix_affinity_enabled",
          "1 when prefix-affinity routing is on",
          1 if routing.get("prefix_affinity") else 0)
    counter("tony_prefix_routed_total",
            "Routing decisions won by the prefix-affinity probe",
            routing.get("prefix_routed", 0))
    counter("tony_handoffs_total",
            "Prefill->decode page-list handoffs relayed",
            routing.get("handoffs", 0))

    # live session migration: fleet totals include the
    # carry folded in by remove_replica, so a retired replica's
    # out-side ledger survives its own departure — per-replica rows
    # above only cover replicas still alive
    counter("tony_migrations_total",
            "Live sessions relayed mid-stream to a new replica",
            routing.get("migrations", 0))
    mig = eng.get("migrations") or {}
    counter("tony_migration_out_total",
            "Sessions frozen + extracted, fleet-wide (carry-inclusive)",
            mig.get("out", 0))
    counter("tony_migration_in_total",
            "Migrated sessions adopted, fleet-wide (carry-inclusive)",
            mig.get("in", 0))
    counter("tony_migration_local_total",
            "Shared-pool owner swaps, both sides counted",
            mig.get("local", 0))
    counter("tony_migration_remote_total",
            "Cross-host wire migrations, both sides counted",
            mig.get("remote", 0))
    counter("tony_migration_pages_moved_total",
            "KV pages physically copied by migrations",
            mig.get("pages_moved", 0))
    counter("tony_migration_bytes_avoided_total",
            "KV bytes owner swaps kept in place instead of copying",
            mig.get("bytes_avoided", 0))
    counter("tony_migration_bytes_wire_total",
            "KV bytes migration payloads actually shipped (delta-"
            "trimmed wire docs count only their suffix pages)",
            mig.get("bytes_wire", 0))
    counter("tony_migration_delta_in_total",
            "Wire adoptions whose prefix pages came from the "
            "adopter's own radix store instead of the payload",
            mig.get("delta_in", 0))
    counter("tony_migration_freeze_resume_ms_total",
            "Milliseconds sessions spent frozen between extract and "
            "adopt", mig.get("freeze_resume_ms", 0.0))

    # the goodput ledger (obs/goodput.py): fleet wall-clock bucket
    # fractions — sum(tony_goodput_fraction) <= 1 by construction, and
    # the values are the same numbers /stats engine.goodput carries
    gp = eng.get("goodput") or {}
    if gp.get("buckets"):
        frac = MetricFamily(
            "tony_goodput_fraction", "gauge",
            "Fleet wall-clock fraction by goodput ledger bucket "
            "(useful.<kind> / compile / padding / overshoot / "
            "spec_rejected / idle; sums to <= 1)")
        for bucket, v in sorted(gp["buckets"].items()):
            frac.add(v, {"bucket": bucket})
        fams.append(frac)
        gauge("tony_goodput_useful_fraction",
              "Fleet useful-work fraction of wall clock",
              gp.get("useful_fraction", 0.0))
        gauge("tony_goodput_wall_seconds",
              "Wall clock attributed by the goodput ledger, summed "
              "across replicas", round(gp.get("wall_ms", 0.0) / 1e3, 3))

    # the adaptive shape controller (serve/autotune.py):
    # actuation counters per knob, convergence state, and the live
    # knob values per replica — the same numbers /stats
    # engine.autotune carries
    auto = eng.get("autotune") or {}
    gauge("tony_autotune_enabled", "1 when the shape controller is on",
          1 if auto.get("enabled") else 0)
    if auto.get("enabled"):
        counter("tony_autotune_ticks_total",
                "Shape-controller evaluation ticks", auto["ticks"])
        counter("tony_autotune_new_compiles_total",
                "Actuations that paid a new program compile",
                auto.get("new_compiles", 0))
        gauge("tony_autotune_converged",
              "1 when no actuation fired for a full hysteresis+"
              "cooldown horizon", 1 if auto.get("converged") else 0)
        acts = MetricFamily(
            "tony_autotune_actuations_total", "counter",
            "Shape-controller actuations, by knob")
        for knob in ("chunk_steps", "speculate_k", "prefill_chunk"):
            acts.add(auto.get("actuations", {}).get(knob, 0),
                     {"knob": knob})
        fams.append(acts)
        knobs = MetricFamily(
            "tony_autotune_knob", "gauge",
            "Live engine shape-knob values under autotune control")
        for rep, vals in sorted(auto.get("replicas", {}).items()):
            for knob, v in sorted(vals.items()):
                knobs.add(v, {"replica": str(rep), "knob": knob})
        fams.append(knobs)

    # alert bus (obs/alerts.py): active alerts as an info-style gauge
    # plus lifetime fire/resolve counters per rule
    al = snap.get("alerts") or {}
    gauge("tony_alerts_enabled", "1 when the alert bus is armed",
          1 if al.get("enabled") else 0)
    if al.get("enabled"):
        gauge("tony_alerts_active_count", "Alerts currently firing",
              len(al.get("active", ())))
        if al.get("active"):
            act = MetricFamily(
                "tony_alerts_active", "gauge",
                "Currently-firing alerts: the labeled alert reads 1")
            for a in al["active"]:
                act.add(1, {"alert": a["alert"],
                            "severity": a["severity"]})
            fams.append(act)
        fired = MetricFamily("tony_alerts_fired_total", "counter",
                             "Alert fire transitions, by rule")
        resolved = MetricFamily(
            "tony_alerts_resolved_total", "counter",
            "Alert resolve transitions, by rule")
        for rule in sorted(al.get("rules", ())):
            labels = {"alert": rule}
            fired.add(al.get("fired", {}).get(rule, 0), labels)
            resolved.add(al.get("resolved", {}).get(rule, 0), labels)
        fams.extend([fired, resolved])

    rep_counter = {name: MetricFamily(name, "counter", help_text)
                   for _, name, help_text in _REPLICA_COUNTERS}
    rep_gauge = {name: MetricFamily(name, "gauge", help_text)
                 for _, name, help_text in _REPLICA_GAUGES}
    state_fam = MetricFamily(
        "tony_replica_state", "gauge",
        "Breaker state info: the labeled state reads 1")
    trans_gauge = {name: MetricFamily(name, "gauge", help_text)
                   for _, name, help_text in _TRANSPORT_GAUGES}
    trans_counter = {name: MetricFamily(name, "counter", help_text)
                     for _, name, help_text in _TRANSPORT_COUNTERS}
    obs_gauge = {name: MetricFamily(name, "gauge", help_text)
                 for _, name, help_text in _OBS_GAUGES}
    obs_counter = {name: MetricFamily(name, "counter", help_text)
                   for _, name, help_text in _OBS_COUNTERS}
    trans_rtt = MetricFamily(
        "tony_transport_rtt_seconds", "gauge",
        "Heartbeat round-trip EMA to the replica agent")
    disp = {
        "tony_dispatch_count_total": MetricFamily(
            "tony_dispatch_count_total", "counter",
            "Engine dispatches by kind"),
        "tony_dispatch_seconds_total": MetricFamily(
            "tony_dispatch_seconds_total", "counter",
            "Host wall seconds spent in dispatches by kind"),
        "tony_dispatch_compiles_total": MetricFamily(
            "tony_dispatch_compiles_total", "counter",
            "First-call (compile) dispatches by kind"),
        "tony_dispatch_compile_seconds_total": MetricFamily(
            "tony_dispatch_compile_seconds_total", "counter",
            "Seconds spent in first-call dispatches by kind"),
        "tony_dispatch_tokens_total": MetricFamily(
            "tony_dispatch_tokens_total", "counter",
            "Tokens landed by dispatches by kind"),
        "tony_dispatch_est_bytes_total": MetricFamily(
            "tony_dispatch_est_bytes_total", "counter",
            "Analytic bytes-moved estimate by kind (obs/goodput.py "
            "cost model)"),
        "tony_dispatch_est_flops_total": MetricFamily(
            "tony_dispatch_est_flops_total", "counter",
            "Analytic FLOPs estimate by kind (obs/goodput.py cost "
            "model)"),
    }
    # host gauges are PROCESS-level (replicas are threads of one
    # process, every /stats row carries the identical block): exported
    # UNLABELED, once — a replica label would make the idiomatic
    # sum() over-report by n_replicas, the exact inflation class the
    # busiest-plane rule (profiler/chrome_trace.py) in this subsystem exists to prevent
    host_rss = MetricFamily("tony_host_rss_bytes", "gauge",
                            "Gateway process-tree resident set size")
    host_mem = MetricFamily("tony_host_gpu_memory_bytes", "gauge",
                            "Card memory torch's allocator holds (absent "
                            "without CUDA)")
    host = (snap["replicas"][0].get("host") or {}) \
        if snap["replicas"] else {}
    if "rss_bytes" in host:
        host_rss.add(host["rss_bytes"])
    if "gpu_mem_bytes" in host:
        host_mem.add(host["gpu_mem_bytes"])
    for i, row in enumerate(snap["replicas"]):
        # rows carry their own fleet index (with elastic membership a
        # row's POSITION no longer equals its replica id)
        labels = {"replica": str(row.get("replica", i))}
        for key, name, _ in _REPLICA_COUNTERS:
            if key in row:
                rep_counter[name].add(row[key], labels)
        for key, name, _ in _REPLICA_GAUGES:
            if key in row:
                rep_gauge[name].add(row[key], labels)
        state_fam.add(1, {**labels, "state": str(row.get("state", ""))})
        tr = row.get("transport")
        if tr:
            # remote replica: the host address rides as a label so a
            # scrape can attribute a bad rtt to a machine directly
            tl = {**labels, "host": str(tr.get("address", ""))}
            trans_rtt.add(round(tr.get("rtt_ms", 0.0) / 1e3, 6), tl)
            for key, name, _ in _TRANSPORT_GAUGES:
                if key in tr:
                    trans_gauge[name].add(tr[key], tl)
            for key, name, _ in _TRANSPORT_COUNTERS:
                if key in tr:
                    trans_counter[name].add(tr[key], tl)
            ob = row.get("obs") or {}
            for key, name, _ in _OBS_GAUGES:
                if ob.get(key) is not None:  # lag absent until a pull
                    obs_gauge[name].add(ob[key], tl)
            for key, name, _ in _OBS_COUNTERS:
                if key in ob:
                    obs_counter[name].add(ob[key], tl)
        for kind, agg in (row.get("dispatch") or {}).items():
            kl = {**labels, "kind": kind}
            disp["tony_dispatch_count_total"].add(agg["count"], kl)
            # /stats keeps ms (human units); the exposition follows the
            # prometheus base-unit convention like every other series
            disp["tony_dispatch_seconds_total"].add(
                round(agg["ms"] / 1e3, 6), kl)
            disp["tony_dispatch_compiles_total"].add(agg["compiles"], kl)
            disp["tony_dispatch_compile_seconds_total"].add(
                round(agg["compile_ms"] / 1e3, 6), kl)
            disp["tony_dispatch_tokens_total"].add(agg["tokens"], kl)
            disp["tony_dispatch_est_bytes_total"].add(
                agg.get("est_bytes", 0), kl)
            disp["tony_dispatch_est_flops_total"].add(
                agg.get("est_flops", 0), kl)
    fams.extend(rep_counter.values())
    fams.extend(rep_gauge.values())
    fams.append(state_fam)
    if trans_rtt.samples:
        fams.append(trans_rtt)
        fams.extend(trans_gauge.values())
        fams.extend(trans_counter.values())
        fams.extend(f for f in obs_gauge.values() if f.samples)
        fams.extend(f for f in obs_counter.values() if f.samples)
    fams.extend(disp.values())
    fams.extend([host_rss, host_mem])

    for key, name, help_text in _HISTOGRAMS:
        hist = gateway.stats.hist.get(key)
        if hist is not None:
            fams.append(hist.family(name, help_text))
    # per-tier queue-wait histogram: one family, a tier label per
    # series (merged samples — duplicate HELP/TYPE headers would break
    # the exposition format)
    # snapshot under the stats lock: _record_done inserts a new
    # tier's Histogram concurrently, and iterating the live dict
    # could raise mid-scrape
    with gateway.stats.lock:
        tier_hists = dict(getattr(gateway.stats, "tier_wait", {}))
    if tier_hists:
        fam = MetricFamily(
            "tony_tier_queue_wait_seconds", "histogram",
            "Submit-to-slot-admission wait per completed request, "
            "by admission tier")
        for tier in sorted(tier_hists):
            fam.samples.extend(tier_hists[tier].family(
                "tony_tier_queue_wait_seconds", "",
                {"tier": tier}).samples)
        fams.append(fam)
    return render(fams)
