"""Decoder-LM pretraining as a tony-tpu job on the card: the port's
counterpart of ``examples/lm-pretrain/pretrain.py``, without the mesh.

Builds Qwen2.5-1.5B at full width (``--config-json`` gives another
Llama-family ``config.json``, ``--layers`` cuts the depth), random from
``--seed``, and trains it through ``fit`` on synthetic tokens with the
captured ``Trainer.step``: bf16 compute over fp32 masters, flash
attention forward, dQ and dK/dV, and fused AdamW. With the job's
``TONY_CHECKPOINT_DIR`` set (``tony.application.checkpoint-dir``) it
checkpoints there, and a coordinator retry resumes from the newest step
(``fit`` reads the variable). ``--fail-after-checkpoint K`` stops attempt
0 with exit code 1 after the checkpoint at step K, so that a retry has
something to resume.

    python -m tony_tpu_torch.cli.local \\
        --executes tony_tpu_torch/examples/lm_pretrain.py \\
        --task_params "--steps 8 --result /tmp/r.json" \\
        --conf tony.worker.instances=1 --conf tony.worker.chips=1

``--device cpu`` (with ``cli.local --device cpu``) runs it on the CPU
through the kernels' plain versions, at a size that fits there.
``--result`` receives one JSON object: the losses, ms a step, each
kernel's launches, the device and the ``CUDA_VISIBLE_DEVICES`` it saw.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))  # repo root, for standalone runs

# Qwen2.5-1.5B, https://huggingface.co/Qwen/Qwen2.5-1.5B config.json
QWEN25_15B = {
    "model_type": "qwen2", "architectures": ["Qwen2ForCausalLM"],
    "hidden_size": 1536, "num_hidden_layers": 28,
    "num_attention_heads": 12, "num_key_value_heads": 2,
    "intermediate_size": 8960, "vocab_size": 151936,
    "hidden_act": "silu", "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
    "tie_word_embeddings": True, "use_sliding_window": False,
    "sliding_window": 131072, "max_window_layers": 21,
    "max_position_embeddings": 131072, "bos_token_id": 151643,
    "eos_token_id": 151643, "torch_dtype": "bfloat16",
}
XENT_CHUNK = 2048


def train_config(hf: dict, max_seq_len: int, **overrides):
    """The training configuration of a Llama-family ``config.json``:
    flash attention (``pallas``, the port's CUDA kernels on the card),
    flash-decode for decoding, remat that keeps the attention outputs."""
    from tony_tpu_torch.models.hf import llama_config

    kw = dict(attention_backend="pallas", remat=True,
              remat_policy="attn_saved", decode_attention="flash")
    kw.update(overrides)
    return llama_config(hf, max_seq_len=max_seq_len, **kw)


def build(cfg, *, seed: int, micro: int, accum: int, seq_len: int,
          lr: float, warmup: int, device: str):
    """``(model, trainer, loader)``: the model random from ``seed`` in
    ``cfg.dtype``, a ``Trainer`` of bf16 compute over fp32 masters with
    ``FusedAdamW`` (``lr`` after a linear ``warmup``, a tensor of the
    step count, as a captured step needs) and ``accum`` micro-batches of
    ``micro`` rows, and a loader over one global batch of synthetic
    tokens from ``seed``, reshuffled each epoch."""
    import numpy as np
    import torch

    from tony_tpu_torch.data import ArraySource, DataLoader
    from tony_tpu_torch.models.transformer import Transformer
    from tony_tpu_torch.ops.xent import chunked_cross_entropy
    from tony_tpu_torch.train import FusedAdamW, Trainer

    model = Transformer(cfg, device=device).init_weights(
        torch.Generator(device=device).manual_seed(seed))
    cdt = torch.bfloat16

    def apply_fn(m, batch):
        hidden = m(batch["tokens"], return_hidden=True)
        return chunked_cross_entropy(hidden[:, :-1], m.embedding,
                                     batch["tokens"][:, 1:],
                                     chunk_size=XENT_CHUNK,
                                     compute_dtype=cdt)

    def warmup_lr(count):
        return lr * torch.clamp((count + 1).float() / warmup, max=1.0)

    trainer = Trainer(model, apply_fn, FusedAdamW(warmup_lr),
                      compute_dtype=cdt, accum_steps=accum)
    gb = micro * accum
    rng = np.random.default_rng(seed)
    data = rng.integers(0, cfg.vocab_size, (gb, seq_len)).astype(np.int64)
    loader = DataLoader(ArraySource({"tokens": data}), gb, seed=seed,
                        device=device)
    return model, trainer, loader


def launches() -> dict:
    """The four training kernels' launch counts in this process (a
    replayed step adds its capture's launches, ``models.graphs``)."""
    from tony_tpu_torch.ops import adamw, attention

    return {"flash_attention_fwd": attention.flash_attention_fwd.launches,
            "flash_attention_bwd_dq":
                attention.flash_attention_bwd_dq.launches,
            "flash_attention_bwd_dkv":
                attention.flash_attention_bwd_dkv.launches,
            "fused_adamw": adamw.fused_adamw_update.launches}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config-json",
                   help="a Llama-family config.json (default Qwen2.5-1.5B)")
    p.add_argument("--layers", type=int, help="cut the depth to N layers")
    p.add_argument("--steps", type=int, default=8,
                   help="the step budget a retry completes")
    p.add_argument("--micro", type=int, default=4)
    p.add_argument("--accum", type=int, default=2)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--max-seq-len", type=int, default=4096)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fail-after-checkpoint", type=int, default=0,
                   metavar="K", help="attempt 0 exits 1 after step K's "
                   "checkpoint")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--result", help="write the JSON result here "
                   "('{attempt}' in the path becomes the attempt number)")
    p.add_argument("--save-params",
                   help="torch.save the final fp32 masters here")
    return p.parse_args(argv)


def main(argv=None) -> int:
    t_start = time.time()
    args = parse_args(argv)
    import torch

    from tony_tpu_torch import constants as C
    from tony_tpu_torch import distributed
    from tony_tpu_torch.train import fit, job_checkpoint_dir

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on "
                           "the CPU")
    distributed.initialize(device=args.device)  # no-op for one worker
    hf = QWEN25_15B
    if args.config_json:
        with open(args.config_json) as f:
            hf = json.load(f)
    if args.layers:
        hf = {**hf, "num_hidden_layers": args.layers}
    cfg = train_config(hf, args.max_seq_len, dtype=torch.bfloat16)
    model, trainer, loader = build(
        cfg, seed=args.seed, micro=args.micro, accum=args.accum,
        seq_len=args.seq_len, lr=args.lr, warmup=args.warmup,
        device=args.device)
    attempt = int(os.environ.get(C.ATTEMPT_NUMBER, "0"))
    fail = args.fail_after_checkpoint > 0 and attempt == 0 \
        and job_checkpoint_dir() is not None
    target = args.fail_after_checkpoint if fail else args.steps

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    stamps = []

    def stamp(step, metrics):
        # step 1's metrics are read once step 2 is queued: wait for the
        # card there, so that the steady window starts where step 2 ends
        if not stamps:
            sync()
        stamps.append(time.time())

    sync()
    t_fit = time.time()
    result = fit(trainer, None, loader, total_steps=target, log_every=1,
                 metric_sinks=[stamp])
    sync()
    t_end = time.time()
    hist = [h for h in result.history if "loss" in h]
    n_params = sum(p.numel() for p in model.parameters())
    run = len(stamps)
    doc = {
        "attempt": attempt, "resumed_from": result.resumed_from,
        "steps_run": result.steps_run, "steps": [h["step"] for h in hist],
        "losses": [h["loss"] for h in hist],
        # steady steps: from the end of step 2 on the card to the end of
        # the last, over their count
        "step_ms": (t_end - stamps[0]) / (run - 2) * 1e3 if run > 2
        else None,
        "launches": launches(), "n_params": n_params,
        "n_layers": cfg.n_layers,
        "tokens_per_step": args.micro * args.accum * args.seq_len,
        "device": torch.cuda.get_device_name(0) if args.device == "cuda"
        else "cpu",
        "cuda_visible_devices": os.environ.get(C.CUDA_VISIBLE_DEVICES),
        "pid": os.getpid(), "agent_pid": os.environ.get(C.AGENT_PID),
        "t_start": t_start, "t_fit": t_fit,
        "t_first_step": stamps[0] if stamps else None, "t_end": t_end,
        "checkpoint": None if result.manager is None else {
            "saves": result.manager.saves,
            "restores": result.manager.restores},
    }
    if args.save_params:
        torch.save({n: t.cpu() for n, t in result.state.params.items()},
                   args.save_params)
    if args.result:
        path = args.result.format(attempt=attempt)
        with open(path + ".tmp", "w") as f:
            json.dump(doc, f)
        os.replace(path + ".tmp", path)
    print(json.dumps({k: doc[k] for k in ("attempt", "resumed_from",
                                          "losses", "step_ms")}))
    if fail:
        print(f"failing attempt 0 after the checkpoint at step {target}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
