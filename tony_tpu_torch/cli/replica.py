"""``python -m tony_tpu_torch.cli.replica`` — one replica agent on this
host (the counterpart of ``tony_tpu/cli/replica.py``).

Boots ONE ``serve.Server`` (the gateway CLI's engine knobs) behind the
agent HTTP shim (``serve/agent.py``) and waits. A gateway launches it
(``--remote-replica``) or attaches to running ones (``--agents``), then
drives it over ``POST /v1/submit`` and the resumable stream channel.

    python -m tony_tpu_torch.cli.replica --demo-model --device cpu \\
        --port 8101

Runs on the GPU unless ``--device cpu``: without CUDA and without that
flag it raises. SIGTERM/SIGINT deregisters by DRAINING: new submits
503, every in-flight and pending request finishes, then exit 0. A second
signal force-exits.

``--port-file`` writes "host port" once the socket is bound: how a
launcher learns an ephemeral port without parsing stdout.
On the card a checkpoint's decode attention runs through the CUDA
flash-decode kernel (``cli.gateway.decode_attention_for``).
``--replica-index`` addresses ``TONY_SERVE_FAULTS`` engine faults at this
agent. ``--mesh`` is refused (ROADMAP.md queue 5); ``--compile-cache``
is XLA's and has no counterpart.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tony-tpu-torch replica",
        description="one serving replica agent (engine + HTTP shim)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--model", help="local checkpoint directory "
                     "(config.json + model.safetensors)")
    src.add_argument("--demo-model", action="store_true",
                     help="serve a tiny random decoder (no checkpoint) "
                          "— for smoke tests")
    p.add_argument("--serve-batch", type=int, default=4,
                   help="cache slots")
    p.add_argument("--chunk-steps", type=int, default=1)
    p.add_argument("--prefill-chunk-tokens", type=int, default=0)
    p.add_argument("--prefix-cache-mb", type=float, default=64.0)
    p.add_argument("--kv-host-mb", type=float, default=0.0)
    p.add_argument("--speculate-k", type=int, default=0)
    p.add_argument("--kv-page-size", type=int, default=0)
    p.add_argument("--kv-pages", type=int, default=0)
    p.add_argument("--no-paged-kv", action="store_true")
    p.add_argument("--mesh", default="",
                   help="not ported to PyTorch yet (ROADMAP.md queue 5): "
                        "refused")
    p.add_argument("--no-in-dispatch-eos", action="store_true")
    p.add_argument("--max-pending", type=int, default=1024)
    p.add_argument("--eos-id", type=int, default=-1)
    p.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32")
    p.add_argument("--hbm-gbps", type=float, default=0.0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8101,
                   help="0 picks an ephemeral port (see --port-file)")
    p.add_argument("--port-file", default="",
                   help="write 'host port' here once bound — how a "
                        "launcher learns an ephemeral port")
    p.add_argument("--replica-index", type=int, default=0,
                   help="fleet index for TONY_SERVE_FAULTS engine-"
                        "fault addressing")
    p.add_argument("--agent-id", default="",
                   help="stable id reported on /healthz (default: "
                        "a generated one)")
    p.add_argument("--profile-dir", default="",
                   help="where POST /v1/profile drops THIS host's "
                        "trace files (default: $TONY_PROFILE_DIR or "
                        "./profiles)")
    p.add_argument("--drain-timeout", type=float, default=120.0,
                   help="max seconds to finish in-flight work on "
                        "SIGTERM")
    p.add_argument("--park-ttl", type=float, default=60.0,
                   help="seconds a parked session (orphaned snapshot "
                        "or finished-but-undelivered result) stays "
                        "adoptable before it is reaped")
    p.add_argument("--gateway-grace", type=float, default=0.0,
                   help="seconds of gateway silence before in-flight "
                        "slots freeze into parked snapshots (0 "
                        "disables the watchdog; in-flight work runs "
                        "to completion and parks as results)")
    return p


def load(args):
    """(model, eos ids) from the flags, on ``args.device``."""
    from tony_tpu_torch.cli.gateway import decode_attention_for, demo_model
    from tony_tpu_torch.models.generate import normalize_eos_ids

    if args.demo_model:
        return demo_model(args.device), normalize_eos_ids(args.eos_id)
    import torch

    from tony_tpu_torch.models.hf import load_hf_dir

    overrides = {"dtype": torch.bfloat16} if args.dtype == "bf16" else {}
    model, hf = load_hf_dir(args.model, device=args.device, **overrides,
                               **decode_attention_for(args.device))
    return model, normalize_eos_ids(args.eos_id) or \
        normalize_eos_ids(hf.get("eos_token_id"))


def build_server(args):
    """The engine, configured exactly like a gateway's in-process
    replica (``cli.gateway.server_factory``): remote must not mean
    different."""
    from tony_tpu_torch.cli.gateway import server_factory

    model, eos = load(args)
    args.replicas = 1  # one engine in this process, on its own pool
    args.no_shared_pool = True
    return server_factory(args, model, eos)(args.replica_index)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mesh.strip():
        print("--mesh is not ported to PyTorch yet (ROADMAP.md queue 5)",
              file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO)

    from tony_tpu_torch.serve.agent import AgentHTTP, ReplicaAgent

    server = build_server(args)
    if server.fault_plan is not None:
        logging.getLogger(__name__).warning(
            "engine fault injection ARMED on this agent (replica %d) "
            "via TONY_SERVE_FAULTS", args.replica_index)
    agent = ReplicaAgent(server, agent_id=args.agent_id or None,
                         profile_dir=args.profile_dir or None,
                         park_ttl_s=args.park_ttl,
                         gateway_grace_s=args.gateway_grace)
    http = AgentHTTP(agent, host=args.host, port=args.port).start()
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{http.host} {http.port}\n")
        os.replace(tmp, args.port_file)  # atomic: launchers poll it
    print(f"tony-tpu-torch replica agent {agent.agent_id} at "
          f"http://{http.host}:{http.port}", flush=True)

    signals_seen = []

    def _on_signal(signum, frame):
        # count SIGNALS, not agent.draining: a gateway-initiated
        # /v1/drain followed by one polite SIGTERM must exit 0
        signals_seen.append(signum)
        if len(signals_seen) > 1:  # second signal: force exit
            os._exit(1)
        print(f"signal {signum}: draining agent (new submits 503, "
              f"finishing in-flight)...", file=sys.stderr, flush=True)
        # drain on a helper thread: the handler must return promptly
        threading.Thread(target=agent.drain,
                         args=(args.drain_timeout,),
                         daemon=True).start()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    agent.drained.wait()
    # drained: a polite SIGTERM still on its way (the stub that sent
    # /v1/drain terminates its agent next) must not kill the exit.
    # Finalization resets a Python handler to the default action, which
    # would end the process with -15; an ignored signal stays ignored
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    http.stop()
    print("agent drained clean", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
