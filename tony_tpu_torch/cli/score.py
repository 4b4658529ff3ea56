"""``python -m tony_tpu_torch.cli.score`` — negative log-likelihood and
perplexity of a local HF checkpoint over given token ids, through the
PyTorch port (counterpart of ``tony_tpu/cli/score.py``).

Each input is padded to a bucket (a power of two, at least 32, capped at
the model's max length) and the padded positions are masked out of the
sum, so scores are exact (causal attention: a pad token can only
influence its own masked-out positions) and match the JAX CLI's, which
buckets so its jitted scorer compiles once a bucket. ``--int8`` scores
the int8 weight-only model (``models.quantize``), ``--kv-int8`` scores
through an int8 KV cache. Inputs are ``--token-ids``: no tokenizer is
ported yet, so ``--text`` and ``--text-file`` are rejected. The
checkpoint directory needs ``config.json`` and one ``model.safetensors``
(GPT-2, Llama, Mistral, Qwen2, Gemma, Mixtral, GPT-NeoX or Phi layout).
Runs on the GPU unless ``--device cpu``.

    python -m tony_tpu_torch.cli.score --model ./ckpt --token-ids 1,2,3,4
"""

from __future__ import annotations

import argparse
import math
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tony-tpu-torch score",
        description="Perplexity of a local HF checkpoint over token ids")
    p.add_argument("--model", required=True,
                   help="local checkpoint directory (config.json + "
                        "model.safetensors)")
    p.add_argument("--text", action="append", default=[],
                   help="text to score: needs a tokenizer, which the "
                        "PyTorch port does not have yet (rejected)")
    p.add_argument("--text-file", action="append", default=[],
                   help="file to score: needs a tokenizer (rejected)")
    p.add_argument("--token-ids", action="append", default=[],
                   help="raw ids, comma-separated (repeatable)")
    p.add_argument("--max-len", type=int, default=0,
                   help="truncate inputs to this many tokens "
                        "(default: the model's max_seq_len)")
    p.add_argument("--kv-int8", action="store_true",
                   help="score THROUGH an int8 KV cache (the decode "
                        "path): the cache quantization's nll/token cost")
    p.add_argument("--int8", action="store_true",
                   help="score with int8 weight-only projections (the "
                        "quality cost of generate --int8)")
    p.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32",
                   help="dense-weight and activation dtype; bf16 "
                        "measures the quality cost of bf16 serving")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


_MIN_BUCKET = 32


def bucket_len(n: int, limit: int) -> int:
    """Smallest power of two >= n (floor 32), capped at ``limit``: the
    serve path's bucketing with a larger floor."""
    from tony_tpu_torch.serve import bucket_len as _bucket

    return _bucket(n, limit, minimum=_MIN_BUCKET)


def make_score_fn(model, through_cache: bool = False):
    """``fn(ids) -> (total nll, token count)`` with the padding masked
    out, by the full forward or, with ``through_cache``, through the KV
    cache (written by the prefill, logits read back through it): with
    ``cfg.kv_cache_quant`` that is the int8 cache's nll/token cost."""
    import torch

    from tony_tpu_torch.models.generate import init_cache

    limit = model.cfg.max_seq_len
    dev = model.device

    @torch.no_grad()
    def score(ids) -> tuple[float, int]:
        ids = ids[:limit]  # a --max-len above the model cap must not
        # overflow the capped bucket
        n = len(ids)
        padded_len = bucket_len(n, limit)
        tokens = torch.zeros(1, padded_len, dtype=torch.long, device=dev)
        tokens[0, :n] = torch.as_tensor(ids, device=dev)
        if through_cache:
            logits = model(tokens, decode=True, cache=init_cache(model, 1))
        else:
            logits = model(tokens)
        logp = torch.log_softmax(logits.float(), dim=-1)
        picked = torch.gather(logp[:, :-1], -1,
                              tokens[:, 1:, None])[0, :, 0]
        # target j (predicted from position j) is real iff j + 1 < n
        mask = torch.arange(1, padded_len, device=dev) < n
        return float(-(picked * mask).sum()), n - 1

    return score


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.text or args.text_file:
        print("--text/--text-file need a tokenizer, which the PyTorch "
              "port does not have yet; pass --token-ids", file=sys.stderr)
        return 2
    inputs = [[int(i) for i in ids.split(",")] for ids in args.token_ids]
    if not inputs:
        print("need --token-ids", file=sys.stderr)
        return 2

    import torch

    from tony_tpu_torch.models.hf import load_hf_dir

    overrides = {"kv_cache_quant": args.kv_int8}
    if args.dtype == "bf16" and args.int8:
        print("note: --int8 supplies its own storage format; "
              "--dtype bf16 is ignored", file=sys.stderr)
    elif args.dtype == "bf16":
        overrides["dtype"] = torch.bfloat16
    try:
        model, _ = load_hf_dir(args.model, device=args.device,
                               int8=args.int8, **overrides)
    except ValueError as e:
        raise SystemExit(str(e))

    limit = min(args.max_len or model.cfg.max_seq_len,
                model.cfg.max_seq_len)
    score = make_score_fn(model, through_cache=args.kv_int8)
    total_nll = 0.0
    total_tokens = 0
    for ids in inputs:
        ids = ids[:limit]
        if len(ids) < 2:
            print("skipping input with < 2 tokens", file=sys.stderr)
            continue
        nll, n = score(ids)
        total_nll += nll
        total_tokens += n
        print(f"tokens={n} nll/token={nll / n:.4f} "
              f"ppl={math.exp(nll / n):.2f}")
    if total_tokens:
        avg = total_nll / total_tokens
        print(f"TOTAL tokens={total_tokens} nll/token={avg:.4f} "
              f"ppl={math.exp(avg):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
