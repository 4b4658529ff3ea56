"""``python -m tony_tpu_torch.cli.generate`` — inference on a local HF
checkpoint through the PyTorch port (counterpart of
``tony_tpu/cli/generate.py``).

One-shot: ``--token-ids 1,2,3`` (repeatable) prints prompt +
continuation as comma-separated ids, in input order; greedy prompts of
one length decode as one batch (up to 32 rows), as the JAX CLI does;
``--repetition-penalty`` applies to them, and ``--num-beams`` > 1 runs
beam search a prompt at a time instead.
``--int8`` loads at fp32 and converts every projection to int8 weights
(``models.quantize``), run through the int8 kernel; ``--serve`` refuses
it, as the JAX CLI does. Serving (``--serve``): one JSON
request per stdin line, ``{"id", "token_ids", "max_new_tokens"?,
"temperature"?, "top_k"?, "seed"?}``, one JSON response per finished
request, ``{"id", "token_ids", "finish_reason"}``, in finish order,
through the gateway core (``tony_tpu_torch.gateway``) over
``--serve-replicas`` ``Server``s, each stepped by its own thread while
stdin is still read; a full admission queue blocks the reader. The
cache is paged unless ``--no-paged-kv`` or the model has a sliding
window (then unpaged, with a note; the prefix store too is turned off
over a window, with a note). Requests
carry ``token_ids``: no tokenizer is ported yet, so a ``prompt`` field
is rejected. The checkpoint directory needs ``config.json`` and one
``model.safetensors`` (GPT-2, Llama, Mistral, Qwen2, Gemma, Mixtral,
GPT-NeoX or Phi layout). Runs on the GPU unless ``--device cpu``.

    printf '%s\\n' '{"id": "a", "token_ids": [1, 2, 3]}' \\
        | python -m tony_tpu_torch.cli.generate --model ./qwen --serve
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tony-tpu-torch generate",
        description="Generate from a local HF checkpoint on the GPU")
    p.add_argument("--model", required=True,
                   help="local checkpoint directory (config.json + "
                        "model.safetensors)")
    p.add_argument("--token-ids", action="append", default=[],
                   help="raw prompt as comma-separated ids (repeatable)")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--num-beams", type=int, default=1,
                   help=">1 uses beam search (overrides sampling knobs)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy")
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--repetition-penalty", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eos-id", type=int, default=-1,
                   help="stop token (default: the config's eos_token_id)")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV cache: quantize-on-write with "
                        "per-(position, head) scales")
    p.add_argument("--flash-decode", action="store_true",
                   help="single-token decode attention through the "
                        "hand-written CUDA flash-decode kernel")
    p.add_argument("--int8", action="store_true",
                   help="int8 weight-only projections through the int8 "
                        "dequant-matmul kernel (half the weight bytes a "
                        "decode step against bf16); one-shot only")
    p.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32",
                   help="dense-weight and activation dtype (embeddings, "
                        "norms and logits stay fp32); bf16 for serving")
    p.add_argument("--serve", action="store_true",
                   help="continuous-batching JSONL loop on stdin/stdout")
    p.add_argument("--serve-batch", type=int, default=4,
                   help="cache slots (resident batch size) in --serve")
    p.add_argument("--serve-replicas", type=int, default=1,
                   help="--serve: engine replicas behind the gateway core, "
                        "each on its own thread (weights shared)")
    p.add_argument("--prefix-cache-mb", type=float, default=64.0,
                   help="--serve: prefix-store byte budget (0 disables)")
    p.add_argument("--speculate-k", type=int, default=0,
                   help="--serve: speculative decoding, up to K "
                        "prompt-lookup draft tokens verified a round "
                        "(greedy outputs unchanged; sampled requests "
                        "decode normally); 0 disables")
    p.add_argument("--kv-page-size", type=int, default=0,
                   help="--serve: tokens per KV page (0 = auto)")
    p.add_argument("--kv-pages", type=int, default=0,
                   help="--serve: page-pool size (0 = every slot can hold "
                        "a full-length sequence)")
    p.add_argument("--no-paged-kv", action="store_true",
                   help="--serve: fixed-shape per-slot cache rows instead "
                        "of the paged pool (sliding-window models "
                        "downgrade automatically)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


def resolve_paged_kv(args, model) -> dict:
    """``Server(paged=..., kv_page_size=..., kv_pages=...)`` from the
    flags: unpaged with ``--no-paged-kv``, and (with a note) for a
    sliding-window model, which the paged cache refuses."""
    if args.no_paged_kv:
        return {"paged": False}
    if model.cfg.sliding_window:
        print("note: paged KV cache disabled (untested over "
              "sliding-window attention)", file=sys.stderr)
        return {"paged": False}
    return {"paged": True, "kv_page_size": args.kv_page_size,
            "kv_pages": args.kv_pages}


def resolve_prefix_cache_mb(args, model) -> float:
    """``--prefix-cache-mb``, turned off (with a note) for a
    sliding-window model, which the prefix store refuses."""
    if args.prefix_cache_mb > 0 and model.cfg.sliding_window:
        print("note: prefix cache disabled (untested over "
              "sliding-window attention)", file=sys.stderr)
        return 0.0
    return args.prefix_cache_mb


def _serve_loop(model, args, eos) -> int:
    """``--serve``: JSONL requests from stdin until EOF through the
    gateway core; one JSONL response a finished request, printed when it
    finishes. Exit 1 when a line was rejected or a request shed."""
    import threading
    import time

    from tony_tpu_torch.gateway import Gateway, GatewayQueueFull, GenRequest
    from tony_tpu_torch.serve import FaultPlan, Server

    n_replicas = max(1, args.serve_replicas)
    prefix_mb = resolve_prefix_cache_mb(args, model)
    paged_kw = resolve_paged_kv(args, model)
    servers = [Server(model, batch_size=args.serve_batch, eos_id=eos,
                      prefix_cache_mb=prefix_mb,
                      speculate_k=args.speculate_k,
                      fault_plan=FaultPlan.from_env(replica=i),
                      device=args.device, **paged_kw)
               for i in range(n_replicas)]
    armed = [i for i, s in enumerate(servers) if s.fault_plan is not None]
    if armed:
        print(f"fault injection ARMED on replica(s) {armed} via "
              "TONY_SERVE_FAULTS", file=sys.stderr)
    gateway = Gateway(servers, max_queue=max(64, 32 * n_replicas)).start()
    n_bad = 0
    n_shed = 0
    out_lock = threading.Lock()

    def on_event(ticket, event):
        nonlocal n_shed
        if event[0] == "done":
            res = event[1]
            new_ids = res.tokens
            stops = [i for i, t in enumerate(new_ids) if t in eos]
            if stops:  # trim at the first stop, as the one-shot path
                new_ids = new_ids[:stops[0]]
            with out_lock:
                print(json.dumps({"id": res.id,
                                  "token_ids": list(res.prompt) + new_ids,
                                  "finish_reason": res.finish_reason}),
                      flush=True)
        elif event[0] == "shed":
            n_shed += 1
            print(f"request {ticket.request.id} shed: {event[2]}",
                  file=sys.stderr)

    for lineno, raw in enumerate(sys.stdin, 1):
        raw = raw.strip()
        if not raw:
            continue
        try:
            d = json.loads(raw)
            if not isinstance(d, dict):
                raise ValueError("request must be a JSON object")
            if "token_ids" not in d:
                raise ValueError(
                    "request needs token_ids (text prompts need a "
                    "tokenizer, which the PyTorch port does not have yet)")
            req = GenRequest(
                [int(x) for x in d["token_ids"]],
                int(d.get("max_new_tokens", args.max_new_tokens)),
                temperature=float(d.get("temperature", args.temperature)),
                top_k=int(d.get("top_k", args.top_k)),
                seed=int(d.get("seed", args.seed)), id=d.get("id"))
            while True:
                try:
                    gateway.submit(req, on_event=on_event)
                    break
                except GatewayQueueFull:
                    time.sleep(0.01)  # pipe backpressure, not rejection
        except Exception as e:  # noqa: BLE001 — a malformed line must
            # not kill the stream and strand every queued request
            print(f"request line {lineno} rejected: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            n_bad += 1
    gateway.drain()
    return 0 if n_bad == 0 and n_shed == 0 else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.serve and not args.token_ids:
        print("need --token-ids or --serve", file=sys.stderr)
        return 2
    if args.serve and args.int8:
        print("--serve does not support --int8 weight quantization "
              "yet", file=sys.stderr)
        return 2

    import torch

    from tony_tpu_torch.models.generate import (beam_search, generate,
                                                normalize_eos_ids)
    from tony_tpu_torch.models.hf import load_hf_dir

    overrides = {"kv_cache_quant": args.kv_int8}
    if args.dtype == "bf16" and args.int8:
        print("note: --int8 supplies its own storage format; "
              "--dtype bf16 is ignored", file=sys.stderr)
    elif args.dtype == "bf16":
        overrides["dtype"] = torch.bfloat16
    if args.flash_decode:
        overrides["decode_attention"] = "flash"
    try:
        model, hf = load_hf_dir(args.model, device=args.device,
                                int8=args.int8, **overrides)
    except ValueError as e:
        raise SystemExit(str(e))
    # HF configs may ship a LIST of eos ids; the loops stop on any
    eos = normalize_eos_ids(args.eos_id) or \
        normalize_eos_ids(hf.get("eos_token_id"))
    if args.serve:
        if args.top_p < 1.0:
            print("warning: --top-p is not applied in --serve mode "
                  "(per-slot sampling supports temperature/top-k); "
                  "ignoring", file=sys.stderr)
        return _serve_loop(model, args, eos)
    prompts = [[int(i) for i in ids.split(",")] for ids in args.token_ids]
    if args.num_beams > 1 and args.repetition_penalty != 1.0:
        print("warning: --repetition-penalty is not applied under "
              "beam search; ignoring", file=sys.stderr)
    outputs: dict[int, list[int]] = {}
    if args.num_beams > 1:  # beam search's batch dim is the beam
        for pos, ids in enumerate(prompts):
            out = beam_search(model, [ids],
                              max_new_tokens=args.max_new_tokens,
                              num_beams=args.num_beams, eos_id=eos)
            outputs[pos] = out[0].tolist()
    # GREEDY same-length prompts decode as one batch (no padding, so
    # positions agree and greedy rows are independent), up to 32 rows a
    # batch; sampled prompts decode one at a time from the seed, so a
    # (prompt, --seed) pair gives the same ids whatever else is asked
    batchable = args.temperature == 0.0
    by_len: dict[int, list[int]] = {}
    for pos, ids in enumerate(prompts):
        if pos not in outputs:
            by_len.setdefault(len(ids) if batchable else pos,
                              []).append(pos)
    max_group = 32  # bounds the batched KV-cache footprint
    gen = torch.Generator(device=model.device)
    for whole in by_len.values():
        for start in range(0, len(whole), max_group):
            group = whole[start:start + max_group]
            gen.manual_seed(args.seed)
            out = generate(model, [prompts[pos] for pos in group],
                           max_new_tokens=args.max_new_tokens,
                           temperature=args.temperature, top_k=args.top_k,
                           top_p=args.top_p, generator=gen, eos_id=eos,
                           repetition_penalty=args.repetition_penalty)
            for row, pos in enumerate(group):
                outputs[pos] = out[row].tolist()
    for pos, ids in enumerate(prompts):  # print in input order
        new_ids = outputs[pos]
        stops = [i for i, t in enumerate(new_ids) if t in eos]
        if stops:
            new_ids = new_ids[:stops[0]]
        print(",".join(str(i) for i in ids + new_ids))
    return 0


if __name__ == "__main__":
    sys.exit(main())
