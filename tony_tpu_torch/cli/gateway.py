"""``python -m tony_tpu_torch.cli.gateway`` — the HTTP serving front
door of the PyTorch port (the counterpart of ``tony_tpu/cli/gateway.py``).

Boots N data-parallel ``serve.Server`` replicas in this process (one
scheduler thread each, weights shared, KV caches private) behind
``tony_tpu_torch.gateway``: bounded admission with per-request
deadlines, least-outstanding-tokens and prefix-affinity routing,
failover, graceful drain on SIGTERM, per-request metrics, traces, the
dispatch timeline, the goodput ledger and alerts on ``/stats`` and
``/metrics`` (and in the portal via ``--history``).

    python -m tony_tpu_torch.cli.gateway --model ./qwen --dtype bf16 \
        --replicas 2 --serve-batch 8 --port 8000

    curl -s localhost:8000/v1/generate -d \
        '{"token_ids": [1, 2, 3], "max_new_tokens": 32}'

Requests carry ``token_ids``: no tokenizer is ported yet (ROADMAP.md
"Waits"), so the gateway runs in the JAX CLI's no-tokenizer mode and a
``prompt`` request is refused. ``--model`` reads ``config.json`` and one
``model.safetensors`` (any family ``models.hf.load_hf_dir`` reads) with
the port's reader; ``--demo-model`` serves a tiny random decoder and boots in seconds on
the CPU. Runs on the GPU unless ``--device cpu``.

Shutdown: SIGTERM/SIGINT stops admission (``/readyz`` -> 503), finishes
every queued + in-flight request, then exits 0. A second signal
force-exits.

Remote replicas: ``--remote-replica`` launches one ``python -m
tony_tpu_torch.cli.replica`` agent per replica on this host and drives
each through a ``gateway.remote.RemoteServer`` (lease heartbeats, epoch
fencing, resumable streams, token-exact failover); ``--agents
host:port,...`` attaches to agents already running, and the gateway
process then loads no weights. ``--roles prefill=N,decode=M`` splits the
fleet into a prefill pool, whose finished prompts hand their pages off,
and a decode pool. ``--kv-host-mb`` puts a host-RAM page tier under each
replica's prefix store. ``--autoscale-max`` arms the autoscaler and
``--rebalance`` the rebalancer, which live-migrates sessions off the
fullest replica. In-process replicas share one page pool (the JAX CLI's
default; handoffs and migrations between them are page-table swaps);
``--no-shared-pool`` gives each its own.

On the card a checkpoint's replicas (and the agents ``cli.replica``
boots) run the decode attention through the CUDA flash-decode kernel;
on the CPU, its plain einsum. Refused with exit 2:
``--mesh`` (ROADMAP.md queue 5). ``--compile-cache`` is XLA's and has no
counterpart.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading

# (flag, set in args?, ROADMAP.md queue)
REFUSED = (
    ("--mesh", lambda a: bool(a.mesh.strip()), 5),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tony-tpu-torch gateway",
        description="HTTP serving front door over N continuous-batching "
                    "replicas")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--model", help="local checkpoint directory "
                     "(config.json + model.safetensors)")
    src.add_argument("--demo-model", action="store_true",
                     help="serve a tiny random decoder (no checkpoint, "
                          "token_ids requests only) — for smoke tests")
    p.add_argument("--remote-replica", action="store_true",
                   help="serve ON replica agents instead of in-process "
                        "threads: launch one `python -m "
                        "tony_tpu_torch.cli.replica` subprocess per "
                        "replica and drive each through a RemoteServer "
                        "stub — lease heartbeats, epoch fencing, "
                        "resumable token streams, token-exact failover "
                        "on agent death")
    p.add_argument("--agents", default="",
                   help="comma-separated host:port of ALREADY RUNNING "
                        "replica agents to attach to (implies remote "
                        "mode; the gateway process loads no weights)")
    p.add_argument("--agent-heartbeat", type=float, default=1.0,
                   help="gateway->agent heartbeat interval in seconds; "
                        "the lease horizon is interval x max(3, "
                        "--agent-lease-misses)")
    p.add_argument("--agent-lease-misses", type=int, default=5,
                   help="missed heartbeats before an agent's lease "
                        "expires (see --agent-heartbeat)")
    p.add_argument("--agent-channel", choices=("mux", "per-ticket"),
                   default="mux",
                   help="gateway->agent streaming transport: 'mux' is "
                        "ONE long-lived connection per replica carrying "
                        "every ticket stream as tagged frames; "
                        "'per-ticket' keeps one connection a request as "
                        "the A/B control")
    p.add_argument("--replicas", type=int, default=1,
                   help="data-parallel serve.Server replicas (each with "
                        "its own KV cache and scheduler thread)")
    p.add_argument("--serve-batch", type=int, default=4,
                   help="cache slots per replica")
    p.add_argument("--chunk-steps", type=int, default=1,
                   help="decode micro-steps fused per dispatch; 1 = "
                        "lowest per-token streaming latency, larger = "
                        "higher throughput")
    p.add_argument("--prefill-chunk-tokens", type=int, default=0,
                   help="chunked prefill: max prompt tokens one "
                        "admission dispatch may consume (quantized to "
                        "the prefill bucket grid); long prompts "
                        "prefill in chunks interleaved between decode "
                        "rounds, capping co-tenant TPOT/TTFT "
                        "starvation. 0 = monolithic (the default)")
    p.add_argument("--roles", default="",
                   help="disaggregated prefill/decode: "
                        "'prefill=N,decode=M' splits the fleet into a "
                        "prefill pool (admission + chunked prefill "
                        "only; finished prompts hand off as page lists) "
                        "and a decode pool. Overrides --replicas to N+M; "
                        "needs the paged KV cache; token-exact vs a "
                        "generalist fleet")
    p.add_argument("--no-prefix-affinity", action="store_true",
                   help="disable prefix-affinity routing (requests "
                        "route to the replica whose radix tree holds "
                        "their longest cached prefix; this flag is "
                        "the A/B control — routing degrades to "
                        "least-outstanding-tokens)")
    p.add_argument("--kv-host-mb", type=float, default=0.0,
                   help="per-replica host-RAM page tier under the prefix "
                        "store: evicted entries spill to the host and "
                        "page back in on a later hit. 0 disables; needs "
                        "the paged cache and a prefix store")
    p.add_argument("--prefix-cache-mb", type=float, default=64.0,
                   help="per-replica byte budget for the prefix "
                        "KV-cache store (radix reuse of shared prompt "
                        "prefixes: exact repeats skip prefill, shared "
                        "system prompts prefill only their suffix). "
                        "0 disables; hit rates show on /stats under "
                        "engine.prefix")
    p.add_argument("--speculate-k", type=int, default=0,
                   help="speculative decoding: max draft tokens per "
                        "slot per verify dispatch (prompt-lookup "
                        "n-gram drafting, batched multi-token "
                        "verification; greedy outputs unchanged, "
                        "sampled requests unaffected). 0 disables; "
                        "acceptance shows on /stats under engine.spec")
    p.add_argument("--kv-page-size", type=int, default=0,
                   help="tokens per KV-cache page (the block-paged "
                        "cache: residency bounded by actual tokens, "
                        "prefix reuse by copy-on-write page sharing). "
                        "0 auto-sizes from max_seq_len; utilization "
                        "shows on /stats under engine.kv_pages")
    p.add_argument("--kv-pages", type=int, default=0,
                   help="KV page-pool size per replica; 0 auto-sizes "
                        "(the unpaged-equivalent footprint)")
    p.add_argument("--no-paged-kv", action="store_true",
                   help="serve fixed-shape per-slot cache rows instead "
                        "of the paged pool (A/B escape hatch; "
                        "sliding-window models downgrade automatically)")
    p.add_argument("--no-shared-pool", action="store_true",
                   help="give each in-process replica its own private "
                        "KV page pool instead of one gateway-owned "
                        "shared pool (the shared pool makes "
                        "prefill->decode handoffs and live session "
                        "migration zero-copy owner swaps, and pools the "
                        "fleet's free-page headroom)")
    p.add_argument("--mesh", default="",
                   help="not ported to PyTorch yet (ROADMAP.md queue 5): refused")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 picks an ephemeral port")
    p.add_argument("--edge", choices=("event", "threaded"),
                   default="event",
                   help="HTTP front end: 'event' (default) is the "
                        "selector edge — one loop thread plus a small "
                        "fixed worker pool holds tens of thousands of "
                        "concurrent NDJSON streams; 'threaded' is the "
                        "thread-per-connection stdlib server, kept as "
                        "the A/B control")
    p.add_argument("--edge-max-connections", type=int, default=16384,
                   help="event edge connection breaker: past this "
                        "many open sockets new connections shed 503 "
                        "with Retry-After instead of degrading "
                        "everyone (threaded edge ignores this)")
    p.add_argument("--edge-workers", type=int, default=4,
                   help="event edge worker threads for blocking "
                        "gateway calls (submit, snapshot); the edge "
                        "itself stays on one loop thread")
    p.add_argument("--edge-write-buffer-kb", type=int, default=256,
                   help="event edge per-connection write buffer bound "
                        "in KiB; a client that cannot keep up beyond "
                        "it gets --edge-drain-timeout to catch up")
    p.add_argument("--edge-drain-timeout", type=float, default=10.0,
                   help="event edge slow-client policy: seconds a "
                        "full write buffer may take to drain before "
                        "the stream is aborted (counted, never pins "
                        "a worker thread)")
    p.add_argument("--edge-io-timeout", type=float, default=30.0,
                   help="event edge bound on reading one request "
                        "(head+body) once its first byte arrives — "
                        "trickled uploads get 408; IDLE keep-alive "
                        "connections are exempt and cost nothing")
    p.add_argument("--max-queue", type=int, default=128,
                   help="admission queue bound; past it requests shed "
                        "with 429")
    p.add_argument("--max-pending", type=int, default=1024,
                   help="per-replica engine queue bound (serve.QueueFull)")
    p.add_argument("--default-ttl", type=float, default=None,
                   help="default per-request deadline in seconds "
                        "(requests may override with ttl_s); expired "
                        "requests shed with 504 before taking a slot")
    p.add_argument("--eos-id", type=int, default=-1,
                   help="stop token (default: model config's "
                        "eos_token_id)")
    p.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32",
                   help="dense-weight and activation dtype (bf16 "
                        "computes in bf16)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    p.add_argument("--history", default="",
                   help="job-history root: record the gateway as a "
                        "portal-browsable job with per-request metrics "
                        "and Chrome-trace rows (metrics/traces.jsonl)")
    p.add_argument("--profile-dir", default="",
                   help="where POST /debug/profile drops its trace "
                        "files (default: <history job dir>/profiles "
                        "with --history, else ./profiles)")
    p.add_argument("--journal", action="store_true",
                   help="arm the durable ticket journal: a "
                        "write-ahead NDJSON log of every admit/route/"
                        "emit-offset/terminal under the history job "
                        "dir, compacted away on clean drain — the "
                        "record --recover replays after a crash. "
                        "Needs --history for a place to land")
    p.add_argument("--journal-fsync", default="batch",
                   choices=("always", "batch", "off"),
                   help="journal durability: 'always' fsyncs every "
                        "append, 'batch' (default) fsyncs admits and "
                        "terminals while emit offsets ride the page "
                        "cache, 'off' never fsyncs")
    p.add_argument("--recover", action="store_true",
                   help="crash recovery boot: replay the newest "
                        "journal under the --history root and "
                        "re-admit every still-live request — parked "
                        "agent sessions are adopted mid-stream "
                        "(token-exact, zero re-prefill), local ones "
                        "re-run from the prompt; clients resume via "
                        "GET /v1/stream/<id>?offset=. A no-op when "
                        "the previous boot drained clean")
    p.add_argument("--park-ttl", type=float, default=60.0,
                   help="seconds a terminal request stays resumable "
                        "at the gateway (GET /v1/stream/<id>) and a "
                        "launched agent keeps orphaned sessions "
                        "adoptable")
    p.add_argument("--agent-grace", type=float, default=0.0,
                   help="launched agents: seconds of gateway silence "
                        "before their in-flight slots freeze into "
                        "parked snapshots (forwarded as the replica "
                        "CLI's --gateway-grace; 0 = park only finished "
                        "results)")
    p.add_argument("--trace-capacity", type=int, default=256,
                   help="recent request traces kept for "
                        "GET /debug/trace/<request_id>; 0 disables "
                        "request tracing")
    p.add_argument("--drain-timeout", type=float, default=120.0,
                   help="max seconds to wait for in-flight requests on "
                        "shutdown")
    p.add_argument("--max-attempts", type=int, default=3,
                   help="engine runs a request may burn across replica "
                        "failures before it sheds 503 (the TonY task-"
                        "retry budget, per request)")
    p.add_argument("--stall-timeout", type=float, default=30.0,
                   help="seconds without a replica-thread heartbeat "
                        "before the watchdog declares it failed and "
                        "fails its requests over; must comfortably "
                        "exceed one step's worst dispatch time "
                        "(first-compile included)")
    p.add_argument("--breaker-base", type=float, default=0.25,
                   help="circuit breaker: first backoff before a failed "
                        "replica is probed (doubles per consecutive "
                        "failure up to --breaker-max)")
    p.add_argument("--breaker-max", type=float, default=8.0,
                   help="circuit breaker: backoff ceiling in seconds")
    p.add_argument("--quarantine-after", type=int, default=5,
                   help="consecutive failures (probe failures included) "
                        "before a replica is quarantined out of the "
                        "rotation for good")
    p.add_argument("--tier-weights", default="",
                   help="admission tier spec 'name=weight,...' "
                        "(default interactive=8,standard=4,batch=1); "
                        "requests pick a tier via their 'priority' "
                        "field, weights shape WFQ interleaving under "
                        "contention (idle fleets give any tier full "
                        "throughput)")
    p.add_argument("--tenant-quota", type=float, default=0.0,
                   help="per-tenant token-rate quota in tokens/s over "
                        "estimated request cost (prompt + budget); a "
                        "tenant over its rate gets 429 + Retry-After. "
                        "0 disables (the default)")
    p.add_argument("--tenant-burst", type=float, default=0.0,
                   help="per-tenant burst bucket in tokens "
                        "(default 4x --tenant-quota)")
    p.add_argument("--autoscale-max", type=int, default=0,
                   help="arm the elastic autoscaler: grow the fleet "
                        "up to this many replicas under queue/SLO "
                        "pressure (probe-admitted), drain back to "
                        "--autoscale-min when idle. 0 = fixed fleet")
    p.add_argument("--autoscale-min", type=int, default=0,
                   help="fleet floor for scale-down (default: "
                        "--replicas)")
    p.add_argument("--autoscale-interval", type=float, default=1.0,
                   help="autoscaler control-loop tick in seconds")
    p.add_argument("--autoscale-up-queue", type=float, default=4.0,
                   help="queued requests per routable replica that "
                        "count as scale-up pressure")
    p.add_argument("--autoscale-up-wait", type=float, default=1.0,
                   help="oldest queued wait (s) that counts as "
                        "scale-up pressure")
    p.add_argument("--autoscale-ttft-slo", type=float, default=0.0,
                   help="TTFT SLO in seconds: scale-up pressure when "
                        ">10%% of a tick's completions exceed it (0 "
                        "disables the SLO-burn signal)")
    p.add_argument("--autoscale-cooldown-up", type=float, default=5.0,
                   help="lockout after a scale-up (s)")
    p.add_argument("--autoscale-cooldown-down", type=float, default=30.0,
                   help="lockout after a scale-down (s)")
    p.add_argument("--rebalance", action="store_true",
                   help="arm the pressure-driven rebalancer "
                        "(gateway/rebalance.py): watches per-replica "
                        "slot-occupancy skew and live-migrates "
                        "in-flight sessions off the fullest replica, "
                        "token-exact")
    p.add_argument("--no-rebalance", action="store_true",
                   help="explicitly disable the rebalancer (the A/B "
                        "control; wins over --rebalance)")
    p.add_argument("--rebalance-interval", type=float, default=1.0,
                   help="rebalancer control-loop tick in seconds")
    p.add_argument("--rebalance-skew", type=float, default=0.5,
                   help="hot-minus-cold occupancy-fraction gap that "
                        "counts as skew (0.5 = 50 points fuller)")
    p.add_argument("--rebalance-stable", type=int, default=2,
                   help="consecutive skewed ticks before a move")
    p.add_argument("--rebalance-cooldown", type=float, default=5.0,
                   help="lockout after a successful move (s); a move "
                        "that found no victim waits twice as long")
    p.add_argument("--no-in-dispatch-eos", action="store_true",
                   help="disable the in-dispatch EOS/refill freeze "
                   " and fused speculation rounds — the "
                   "pre-freeze engine behavior, kept as an A/B "
                   "control; costs chunk overshoot at depth")
    p.add_argument("--autotune", action="store_true",
                   help="arm the ledger-driven adaptive shape "
                   "controller (serve/autotune.py): steers "
                   "chunk-steps / speculate-k / prefill-chunk per "
                   "replica from the goodput ledger, within the "
                   "--autotune-* bounds; decisions go to /stats "
                   "engine.autotune, tony_autotune_* metrics, and "
                   "history metrics/autotune.jsonl")
    p.add_argument("--autotune-interval", type=float, default=1.0,
                   help="seconds between controller ticks")
    p.add_argument("--autotune-chunk-min", type=int, default=1,
                   help="chunk-steps floor the controller may steer to")
    p.add_argument("--autotune-chunk-max", type=int, default=32,
                   help="chunk-steps ceiling (0 pins chunk-steps)")
    p.add_argument("--autotune-spec-max", type=int, default=16,
                   help="speculate-k ceiling (0 pins speculate-k; the "
                   "controller never re-arms speculation from 0)")
    p.add_argument("--autotune-prefill-max", type=int, default=0,
                   help="prefill-chunk-tokens ceiling (0 = leave the "
                   "prefill chunk budget alone)")
    p.add_argument("--autotune-hold", type=int, default=2,
                   help="consecutive same-direction ticks before an "
                   "actuation (hysteresis)")
    p.add_argument("--autotune-cooldown", type=int, default=3,
                   help="ticks after an actuation during which the "
                   "knob is not re-judged")
    p.add_argument("--hbm-gbps", type=float, default=0.0,
                   help="peak HBM bandwidth reference in GB/s for the "
                        "goodput ledger's per-dispatch HBM-BW%% / MFU "
                        "estimates (0 auto-detects from the card "
                        "table / TONY_HBM_GBPS; unknown cards and the "
                        "CPU report bytes with utilization null)")
    p.add_argument("--no-alerts", action="store_true",
                   help="disable the serving alert bus (rule engine "
                        "over queue/KV/SLO/breaker/goodput signals "
                        "feeding /stats alerts, tony_alerts_* and "
                        "history alerts.jsonl) — the A/B escape hatch")
    p.add_argument("--alert-interval", type=float, default=1.0,
                   help="alert rule evaluation cadence in seconds")
    p.add_argument("--alert-queue-wait", type=float, default=5.0,
                   help="queue_aging alert: oldest queued wait (s) "
                        "that counts as an aging queue")
    p.add_argument("--alert-kv-free-frac", type=float, default=0.15,
                   help="kv_pages_pressure alert: free-after-"
                        "reservation fraction of the page pool under "
                        "which live load counts as pressure")
    p.add_argument("--alert-host-thrash-bytes", type=float,
                   default=float(1 << 20),
                   help="kv_host_thrash alert: host-tier page-in "
                        "bytes per evaluation tick that, together "
                        "with kv_pages_pressure, count as "
                        "spill/restore churn")
    p.add_argument("--alert-ttft-slo", type=float, default=0.0,
                   help="ttft_slo_burn alert: TTFT SLO in seconds "
                        "(>10%% of a tick's completions over it "
                        "fires; 0 disables the rule)")
    p.add_argument("--alert-shed-storm", type=int, default=50,
                   help="shed_storm alert: capacity sheds "
                        "(429/503/504, quota excluded) within the "
                        "storm window that count as a storm")
    p.add_argument("--alert-shed-window", type=float, default=10.0,
                   help="shed_storm alert: rate window in seconds")
    p.add_argument("--no-alert-bundles", action="store_true",
                   help="disable the flight recorder: by default a "
                        "FIRING alert dumps one self-contained debug "
                        "bundle (active alerts, recent traces incl. "
                        "remote spans, per-replica dispatch/goodput/"
                        "transport blocks, scale signals) into "
                        "<history job dir>/bundles/ — needs --history "
                        "for a place to land; GET /debug/bundle "
                        "serves the same document on demand either "
                        "way")
    return p


def demo_model(device=None):
    """A tiny random decoder: boots in seconds on the CPU and exercises
    the whole serving stack (prefill buckets, per-slot decode, EOS
    evict)."""
    import torch

    from tony_tpu_torch.models import Transformer, TransformerConfig

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                            n_layers=2, d_ff=64, max_seq_len=64,
                            dtype=torch.float32,
                            attention_backend="reference")
    return Transformer(cfg, device=device).init_weights(
        torch.Generator().manual_seed(0))


def decode_attention_for(device) -> dict:
    """The checkpoint loader's decode-attention override for ``device``:
    the CUDA flash-decode kernel on the card (default ``cuda``), the
    plain einsum elsewhere."""
    import torch

    if torch.device(device or "cuda").type == "cuda":
        return {"decode_attention": "flash"}
    return {}


def server_factory(args, model, eos):
    """``make(index) -> Server``: one replica engine from parsed args,
    over the shared ``model``, with its own prefix store (and host tier
    with ``--kv-host-mb``); ``TONY_SERVE_FAULTS`` applies by its fleet
    index. Shared by the boot replicas and the autoscaler, so a grown
    replica is configured as a boot one. Paged replicas share ONE page
    pool (sized for the fleet ceiling, allocated before any replica
    captures a graph) unless ``--no-shared-pool``."""
    from tony_tpu_torch.cli.generate import (resolve_paged_kv,
                                             resolve_prefix_cache_mb)
    from tony_tpu_torch.serve import FaultPlan, Server

    prefix_mb = resolve_prefix_cache_mb(args, model)
    paged_kw = resolve_paged_kv(args, model)
    ceiling = max(1, args.replicas, getattr(args, "autoscale_max", 0) or 0)
    # the host tier spills EVICTED prefix-store entries: with the store
    # off there is nothing to spill, so it goes off loudly
    kv_host_mb = args.kv_host_mb
    if kv_host_mb > 0 and (prefix_mb <= 0 or not paged_kw["paged"]):
        logging.getLogger(__name__).warning(
            "--kv-host-mb ignored: the host page tier needs the paged "
            "KV cache and a prefix store (--prefix-cache-mb > 0)")
        kv_host_mb = 0.0
    pool = None
    if paged_kw["paged"] and not args.no_shared_pool:
        from tony_tpu_torch.serve.slots import PagePool, default_page_size

        cfg = model.cfg
        ps = paged_kw.get("kv_page_size", 0) or default_page_size(cfg)
        ps = max(1, min(int(ps), cfg.max_seq_len))
        per_replica = paged_kw.get("kv_pages", 0) \
            or args.serve_batch * (-(-cfg.max_seq_len // ps))
        pool = PagePool(model, int(per_replica) * ceiling, ps,
                        shared=True)

    def make(index: int):
        return Server(model, batch_size=args.serve_batch,
                      eos_id=eos, chunk_steps=args.chunk_steps,
                      max_pending=args.max_pending,
                      prefix_cache_mb=prefix_mb,
                      speculate_k=args.speculate_k,
                      fault_plan=FaultPlan.from_env(replica=index),
                      hbm_gbps=args.hbm_gbps,
                      prefill_chunk_tokens=args.prefill_chunk_tokens,
                      kv_host_mb=kv_host_mb,
                      in_dispatch_eos=not args.no_in_dispatch_eos,
                      page_pool=pool, device=args.device, **paged_kw)

    return make


def parse_roles(spec: str) -> list | None:
    """``--roles prefill=N,decode=M`` -> the per-replica role list
    (prefill replicas first)."""
    if not spec.strip():
        return None
    counts = {"prefill": 0, "decode": 0}
    for part in spec.split(","):
        name, sep, n = part.strip().partition("=")
        if not sep or name not in counts:
            raise SystemExit(
                f"--roles expects 'prefill=N,decode=M', got {spec!r}")
        try:
            counts[name] = int(n)
        except ValueError:
            raise SystemExit(f"--roles count {n!r} is not an integer") \
                from None
    if counts["prefill"] < 1 or counts["decode"] < 1:
        raise SystemExit("--roles needs at least one prefill AND one "
                         "decode replica")
    return ["prefill"] * counts["prefill"] \
        + ["decode"] * counts["decode"]


def agent_argv(args, index: int) -> list:
    """The ``python -m tony_tpu_torch.cli.replica`` argv mirroring this
    gateway's engine knobs: a launched agent is configured exactly as an
    in-process replica would have been."""
    argv = ["--serve-batch", str(args.serve_batch),
            "--chunk-steps", str(args.chunk_steps),
            "--prefill-chunk-tokens", str(args.prefill_chunk_tokens),
            "--prefix-cache-mb", str(args.prefix_cache_mb),
            "--kv-host-mb", str(args.kv_host_mb),
            "--speculate-k", str(args.speculate_k),
            "--kv-page-size", str(args.kv_page_size),
            "--kv-pages", str(args.kv_pages),
            "--max-pending", str(args.max_pending),
            "--eos-id", str(args.eos_id),
            "--dtype", args.dtype,
            "--hbm-gbps", str(args.hbm_gbps),
            "--replica-index", str(index),
            "--park-ttl", str(args.park_ttl),
            "--gateway-grace", str(args.agent_grace),
            "--port", "0"]
    if args.device:
        argv += ["--device", args.device]
    if args.profile_dir:
        # launched agents share THIS host: their captures land under the
        # gateway's profile dir, one subdir an agent
        argv += ["--profile-dir",
                 os.path.join(args.profile_dir, f"agent-{index}")]
    if args.no_paged_kv:
        argv.append("--no-paged-kv")
    if args.no_in_dispatch_eos:
        argv.append("--no-in-dispatch-eos")
    if args.demo_model:
        argv.append("--demo-model")
    else:
        argv += ["--model", args.model]
    return argv


def remote_server_factory(args):
    """``make(index, hosts=None) -> RemoteServer``, the remote twin of
    ``server_factory``: a ``host:port`` entry in ``hosts`` attaches to
    an agent already listening there; no hosts (or localhost) launches
    the agent as a local subprocess (``launch_local_agent``).
    ``TONY_SERVE_FAULTS`` transport faults arm at the stub by fleet
    index, engine faults in the launched agent's environment."""
    import tempfile

    from tony_tpu_torch.gateway.remote import (RemoteServer,
                                               launch_local_agent)
    from tony_tpu_torch.serve import FaultPlan

    def stub(address: str, index: int, proc=None) -> RemoteServer:
        return RemoteServer(
            address,
            heartbeat_interval_s=args.agent_heartbeat,
            lease_misses=args.agent_lease_misses,
            stall_timeout_s=args.stall_timeout,
            agent_channel=args.agent_channel,
            transport_faults=FaultPlan.transport_from_env(replica=index),
            agent_proc=proc)

    def make(index: int, hosts=None) -> RemoteServer:
        if hosts:
            h = str(hosts[0])
            if ":" in h:
                return stub(h, index)
            if h not in ("localhost", "127.0.0.1"):
                raise ValueError(
                    f"remote host {h!r} must either run `python -m "
                    f"tony_tpu_torch.cli.replica` itself and be given as "
                    f"host:port, or be localhost (subprocess launch)")
        port_dir = tempfile.mkdtemp(prefix=f"tony-agent-{index}-")
        proc, address = launch_local_agent(
            agent_argv(args, index),
            port_file=os.path.join(port_dir, "agent.port"))
        try:
            return stub(address, index, proc=proc)
        except Exception:
            # the stub never existed, so nothing will close() it: reap
            # the agent here
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except Exception:  # noqa: BLE001 — best-effort teardown
                proc.kill()
            raise

    return make


def build_gateway(args, model, eos, *, metrics_store=None):
    """Servers + Gateway from parsed args (shared with tests). Remote
    mode (``--agents`` attach / ``--remote-replica`` launch) ignores
    ``model``: the agents own the weights and the gateway is a pure
    router."""
    from tony_tpu_torch.gateway import Gateway, GatewayHistory

    agents = [a.strip() for a in args.agents.split(",") if a.strip()]
    # a role split sizes the fleet itself: prefill=N,decode=M is N+M
    roles = parse_roles(args.roles)
    if roles:
        if agents and len(agents) != len(roles):
            raise SystemExit(
                f"--roles names {len(roles)} replicas but --agents "
                f"lists {len(agents)}")
        args.replicas = len(roles)
    if agents:
        rmake = remote_server_factory(args)
        servers = [rmake(i, hosts=[addr]) for i, addr in enumerate(agents)]
    elif args.remote_replica:
        rmake = remote_server_factory(args)
        servers = [rmake(i) for i in range(max(1, args.replicas))]
    else:
        make = server_factory(args, model, eos)
        servers = [make(i) for i in range(max(1, args.replicas))]
    armed = [i for i, s in enumerate(servers)
             if s.fault_plan is not None
             or getattr(s, "transport_faults", None) is not None]
    if armed:
        logging.getLogger(__name__).warning(
            "fault injection ARMED on replica(s) %s via TONY_SERVE_FAULTS",
            armed)
    history = None
    if args.history:
        history = GatewayHistory(args.history, n_replicas=len(servers))
    journal = None
    if args.journal or args.recover:
        # the WAL lands in THIS boot's history job dir; --recover
        # implies journaling
        if history is None:
            raise SystemExit("--journal/--recover need --history for "
                             "a place to put the journal")
        from tony_tpu_torch.gateway.journal import TicketJournal

        journal = TicketJournal(
            os.path.join(history.job_dir, "journal.ndjson"),
            fsync=args.journal_fsync)
    trace_capacity = args.trace_capacity
    return Gateway(servers, max_queue=args.max_queue,
                   default_ttl_s=args.default_ttl,
                   journal=journal, park_ttl_s=args.park_ttl,
                   metrics_store=metrics_store, history=history,
                   max_attempts=args.max_attempts,
                   stall_timeout_s=args.stall_timeout,
                   breaker_base_s=args.breaker_base,
                   breaker_max_s=args.breaker_max,
                   quarantine_after=args.quarantine_after,
                   tracing=trace_capacity > 0,
                   trace_capacity=max(1, trace_capacity),
                   profile_dir=args.profile_dir or None,
                   tier_weights=args.tier_weights or None,
                   tenant_quota_rate=args.tenant_quota,
                   tenant_quota_burst=args.tenant_burst,
                   alerts=not args.no_alerts,
                   alert_interval_s=args.alert_interval,
                   alert_thresholds={
                       "queue_wait_s": args.alert_queue_wait,
                       "kv_free_frac": args.alert_kv_free_frac,
                       "ttft_slo_s": args.alert_ttft_slo,
                       "host_thrash_bytes": args.alert_host_thrash_bytes,
                       "shed_storm_count": args.alert_shed_storm,
                       "shed_storm_window_s": args.alert_shed_window,
                   },
                   bundle_on_alert=not args.no_alert_bundles,
                   roles=roles,
                   prefix_affinity=not args.no_prefix_affinity,
                   autotune=args.autotune,
                   autotune_interval_s=args.autotune_interval,
                   autotune_config={
                       "chunk_bounds": (max(1, args.autotune_chunk_min),
                                        args.autotune_chunk_max),
                       "spec_bounds": (0, args.autotune_spec_max),
                       "prefill_bounds": (0, args.autotune_prefill_max),
                       "hold_ticks": args.autotune_hold,
                       "cooldown_ticks": args.autotune_cooldown,
                   } if args.autotune else None)


def build_scaler(args, gateway, model, eos):
    """The elastic autoscaler when ``--autoscale-max`` asks for one: a
    ThreadBackend over the factory the boot replicas came from (a
    grown replica shares the weights, or is another launched agent in
    remote mode). None when not armed."""
    max_replicas = args.autoscale_max
    if not max_replicas:
        return None
    if args.roles.strip():
        raise SystemExit("--autoscale-max cannot be combined with "
                         "--roles (fixed role-split fleets only)")
    from tony_tpu_torch.gateway import AutoScaler, ThreadBackend

    boot = max(1, args.replicas)
    if max_replicas < boot:
        raise SystemExit(f"--autoscale-max {max_replicas} is below "
                         f"--replicas {boot}")
    floor = max(1, args.autoscale_min or boot)
    if floor > max_replicas:
        raise SystemExit(f"--autoscale-min {floor} is above "
                         f"--autoscale-max {max_replicas}")
    if args.agents.strip():
        raise SystemExit(
            "--autoscale-max cannot mint new agents in --agents attach "
            "mode (the fleet is the given list); use --remote-replica")
    # a grown replica's fleet index is where the replica list ends when
    # it is made (only the scaler thread adds)
    if args.remote_replica:
        rmake = remote_server_factory(args)
        backend = ThreadBackend(
            lambda: rmake(len(gateway.replicas)), label="remote-agent")
    else:
        make = server_factory(args, model, eos)
        backend = ThreadBackend(lambda: make(len(gateway.replicas)))
    return AutoScaler(
        gateway, backend,
        min_replicas=floor,
        max_replicas=max_replicas,
        interval_s=args.autoscale_interval,
        up_queue_depth=args.autoscale_up_queue,
        up_wait_s=args.autoscale_up_wait,
        ttft_slo_s=args.autoscale_ttft_slo,
        cooldown_up_s=args.autoscale_cooldown_up,
        cooldown_down_s=args.autoscale_cooldown_down,
        drain_timeout_s=args.drain_timeout)


def build_rebalancer(args, gateway):
    """The pressure-driven rebalancer when ``--rebalance`` asks for one
    (``--no-rebalance`` wins). None when not armed."""
    if args.no_rebalance or not args.rebalance:
        return None
    from tony_tpu_torch.gateway import Rebalancer

    cooldown = args.rebalance_cooldown
    return Rebalancer(
        gateway,
        interval_s=args.rebalance_interval,
        skew_frac=args.rebalance_skew,
        stable=args.rebalance_stable,
        cooldown_s=cooldown,
        fail_cooldown_s=2 * cooldown)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for flag, on, queue in REFUSED:
        if on(args):
            print(f"{flag} is not ported to PyTorch yet (ROADMAP.md "
                  f"queue {queue})", file=sys.stderr)
            return 2
    remote = bool(args.agents.strip()) or args.remote_replica
    if not args.model and not args.demo_model and not args.agents:
        parser.error("one of --model / --demo-model / --agents is "
                     "required")
    if args.remote_replica and not (args.model or args.demo_model):
        parser.error("--remote-replica needs --model or --demo-model "
                     "to hand to the launched agents")
    logging.basicConfig(level=logging.INFO)

    from tony_tpu_torch.models.generate import normalize_eos_ids

    model, eos = None, []
    if remote:
        pass  # a pure router: the agents own the weights
    elif args.demo_model:
        model = demo_model(args.device)
        eos = normalize_eos_ids(args.eos_id)
    else:
        import torch

        from tony_tpu_torch.models.hf import load_hf_dir

        overrides = {"dtype": torch.bfloat16} if args.dtype == "bf16" \
            else {}
        model, hf = load_hf_dir(args.model, device=args.device,
                                   **overrides,
                                   **decode_attention_for(args.device))
        eos = normalize_eos_ids(args.eos_id) or \
            normalize_eos_ids(hf.get("eos_token_id"))
    print("note: no tokenizer in the PyTorch port; token_ids requests "
          "only", file=sys.stderr)

    from tony_tpu_torch.gateway import GatewayEdge, GatewayHTTP
    from tony_tpu_torch.metrics import MetricsStore

    # --recover: find the DEAD boot's journal BEFORE build_gateway
    # creates this boot's (fresh, newest-mtime) one
    recover_entries = None
    if args.recover:
        from tony_tpu_torch.gateway import journal as journal_mod

        prev = journal_mod.find_latest(args.history) \
            if args.history else None
        recover_entries = journal_mod.replay(prev) if prev else {}
        n_live = sum(1 for e in recover_entries.values() if e.live)
        print(f"recovery: replayed "
              f"{prev or '(no previous journal)'} — "
              f"{n_live} live request(s)", file=sys.stderr, flush=True)

    gateway = build_gateway(args, model, eos,
                            metrics_store=MetricsStore()).start()
    if recover_entries is not None:
        report = gateway.recover_from_journal(recover_entries)
        print(f"recovery: {report['adopted']} adopted mid-stream, "
              f"{report['rerun']} re-run from prompt, "
              f"{report['finished']} finished results, "
              f"{report['shed']} shed "
              f"({report.get('wall_ms', 0):.0f}ms)",
              file=sys.stderr, flush=True)
    scaler = build_scaler(args, gateway, model, eos)
    if scaler is not None:
        scaler.start()
    rebalancer = build_rebalancer(args, gateway)
    if rebalancer is not None:
        rebalancer.start()
    if args.edge == "event":
        http = GatewayEdge(
            gateway, host=args.host, port=args.port,
            max_connections=args.edge_max_connections,
            workers=args.edge_workers,
            write_buffer_kb=args.edge_write_buffer_kb,
            drain_timeout_s=args.edge_drain_timeout,
            io_timeout_s=args.edge_io_timeout).start()
    else:
        http = GatewayHTTP(gateway, host=args.host, port=args.port).start()
    elastic = "" if scaler is None else \
        f", autoscale {scaler.min_replicas}-{scaler.max_replicas}"
    if rebalancer is not None:
        elastic += ", rebalance on"
    mode = ""
    if remote:
        mode = " remote agents: " + ", ".join(
            r.host for r in gateway.replicas)
    print(f"tony-tpu-torch gateway at http://{http.host}:{http.port} "
          f"({len(gateway.replicas)} replica(s) x {args.serve_batch} "
          f"slots{elastic}{mode})", flush=True)

    stop = threading.Event()

    def _on_signal(signum, frame):
        if stop.is_set():  # second signal: force exit
            os._exit(1)
        print(f"signal {signum}: draining (readyz -> 503, finishing "
              f"in-flight)...", file=sys.stderr, flush=True)
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    stop.wait()
    ok = gateway.drain(timeout=args.drain_timeout)
    http.stop()
    if not ok:
        print("drain timed out with requests still in flight",
              file=sys.stderr)
        return 1
    print("drained clean", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
