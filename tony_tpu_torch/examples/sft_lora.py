"""LoRA supervised fine-tuning as a tony-tpu job: the port's counterpart
of ``examples/sft-lora/finetune.py``.

``JsonlSource`` -> ``InstructionSource`` (the loss masked to the
completions) -> a frozen base with rank-``--rank`` adapters on ``q, v,
o, wi, wo`` -> ``fit`` with ``FusedAdamW`` at weight decay 0 (which is
Adam, the reference's ``optax.adam``) -> ``materialize_lora`` and a
greedy ``generate`` of each toy pair's completion as the self-check: at
least 3 of the 4 learned, else exit 1. Batches come from a
``DataLoader`` on the host through ``device_prefetch``.

The default model is the reference example's toy configuration (the
byte tokenizer's 257 ids, width 64, 4 heads, 2 layers, fp32).
``--config-json`` (a Llama-family ``config.json``) and ``--layers`` take
another model, as ``lm_pretrain.py`` does: its training configuration
(flash attention, remat), a bf16 base random from ``--seed``, the byte
tokenizer's ids inside its vocabulary.

    python -m tony_tpu_torch.cli.local \\
        --executes tony_tpu_torch/examples/sft_lora.py \\
        --task_params "--steps 200 --result /tmp/r.json" \\
        --conf tony.worker.instances=1 --conf tony.worker.chips=1

``--device cpu`` (with ``cli.local --device cpu``) runs it on the CPU.
``--result`` receives one JSON object: the losses, the adapter and base
parameter counts, the optimizer state's bytes, the self-check, each
training kernel's launches and the device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))  # repo root, for standalone runs

PAIRS = [{"prompt": "2+2=", "completion": "4"},
         {"prompt": "3+3=", "completion": "6"},
         {"prompt": "1+1=", "completion": "2"},
         {"prompt": "4+4=", "completion": "8"}]
TARGETS = ("q", "v", "o", "wi", "wo")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=8)
    p.add_argument("--rank", type=int, default=8)
    p.add_argument("--alpha", type=float, default=16.0)
    p.add_argument("--data", default="",
                   help="instruction jsonl (prompt/completion per line); "
                        "default: a generated toy arithmetic set")
    p.add_argument("--config-json",
                   help="a Llama-family config.json (default: the "
                        "reference example's toy model)")
    p.add_argument("--layers", type=int, help="cut the depth to N layers")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--result", help="write the JSON result here")
    return p.parse_args(argv)


def model_config(args, vocab_size: int):
    """The toy configuration of the reference example, or the training
    configuration of ``--config-json`` in bf16."""
    import torch

    from tony_tpu_torch.examples.lm_pretrain import train_config
    from tony_tpu_torch.models import TransformerConfig

    if not args.config_json:
        cfg = TransformerConfig(
            vocab_size=vocab_size, d_model=64, n_heads=4,
            n_layers=args.layers or 2, d_ff=128, max_seq_len=args.seq_len,
            dtype=torch.float32, attention_backend="reference")
    else:
        with open(args.config_json) as f:
            hf = json.load(f)
        if args.layers:
            hf = {**hf, "num_hidden_layers": args.layers}
        cfg = train_config(hf, args.seq_len, dtype=torch.bfloat16)
    if cfg.vocab_size < vocab_size:
        raise ValueError(f"the model's vocabulary ({cfg.vocab_size}) does "
                         f"not hold the byte tokenizer's {vocab_size} ids")
    return cfg


def main(argv=None) -> int:
    t_start = time.time()
    args = parse_args(argv)
    import torch

    from tony_tpu_torch import distributed
    from tony_tpu_torch.data import (ByteTokenizer, DataLoader,
                                     InstructionSource, JsonlSource,
                                     device_prefetch)
    from tony_tpu_torch.examples.lm_pretrain import launches
    from tony_tpu_torch.models import Transformer, generate
    from tony_tpu_torch.train import (FusedAdamW, Trainer,
                                      cross_entropy_loss, fit, lora_init,
                                      lora_param_count, materialize_lora,
                                      wrap_apply_fn)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on "
                           "the CPU")
    distributed.initialize(device=args.device)  # no-op for one worker

    data = args.data
    if not data:
        work = os.environ.get("TONY_JOB_DIR") or tempfile.mkdtemp(
            prefix="sft-lora-")
        # per-task file name: gang workers share the job dir
        idx = os.environ.get("TONY_TASK_INDEX", "0")
        data = os.path.join(work, f"sft-{idx}.jsonl")
        with open(data, "w") as f:
            f.write("\n".join(json.dumps(r) for r in PAIRS * 4) + "\n")

    tok = ByteTokenizer()
    src = InstructionSource(JsonlSource(data), tok, seq_len=args.seq_len,
                            eos_id=tok.eos_id)
    loader = device_prefetch(DataLoader(src, args.global_batch, seed=1,
                                        device="cpu"), device=args.device)

    cfg = model_config(args, tok.vocab_size)
    base = Transformer(cfg, device=args.device).init_weights(
        torch.Generator(device=args.device).manual_seed(args.seed))

    def base_apply(model, batch):
        logits = model(batch["tokens"])
        return cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:],
                                  mask=batch["loss_mask"][:, 1:])

    lora = lora_init(torch.Generator(device=args.device).manual_seed(
        args.seed + 1), base, rank=args.rank, targets=TARGETS)
    n_lora = lora_param_count(lora)
    n_base = sum(p.numel() for p in base.parameters())
    print(f"LoRA adapters: {n_lora} params (base frozen: {n_base})")
    trainer = Trainer(lora, wrap_apply_fn(base_apply, base,
                                          alpha=args.alpha),
                      FusedAdamW(1e-2, weight_decay=0.0))
    t_fit = time.time()
    result = fit(trainer, None, loader, num_steps=args.steps,
                 log_every=max(args.steps // 4, 1))
    if args.device == "cuda":
        torch.cuda.synchronize()
    t_end = time.time()
    opt = result.state.opt_state
    doc = {"losses": [h["loss"] for h in result.history if "loss" in h],
           "steps_run": result.steps_run, "adapter_params": n_lora,
           "base_params": n_base, "n_layers": cfg.n_layers,
           "opt_state_bytes": sum(t.numel() * t.element_size() for t in
                                  [*opt.mu.values(), *opt.nu.values()]),
           "launches": launches(), "pid": os.getpid(),
           "device": torch.cuda.get_device_name(0)
           if args.device == "cuda" else "cpu",
           "t_start": t_start, "t_fit": t_fit, "t_end": t_end}

    hits = None
    if not args.data:  # user datasets have no answer key to decode against
        served = Transformer(cfg, device=args.device)
        served.load_state_dict(materialize_lora(base, result.state.params,
                                                alpha=args.alpha))
        hits = 0
        for row in PAIRS:
            out = generate(served, [tok.encode(row["prompt"])],
                           max_new_tokens=1)
            got = tok.decode([int(out[0, 0])])
            hits += got == row["completion"]
            print(f"  {row['prompt']!r} -> {got!r} "
                  f"(want {row['completion']!r})")
        print(f"learned {hits}/{len(PAIRS)} completions after "
              f"{args.steps} steps")
    doc["hits"] = hits
    if args.result:
        with open(args.result + ".tmp", "w") as f:
            json.dump(doc, f)
        os.replace(args.result + ".tmp", args.result)
    return 0 if hits is None or hits >= len(PAIRS) - 1 else 1


if __name__ == "__main__":
    raise SystemExit(main())
