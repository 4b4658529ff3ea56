"""Where the paged and the unpaged bf16 prefills part from fp32: each
layer's output and the last position's logits of both serving prefills
of Qwen2.5-1.5B (28 layers, bf16, ``chip_smoke.py``'s phase 4 weights
and prompts), held against the fp32 plain forward of the same weights
on the same prompt.

- paged: the ``Server``'s paged prefill (``serve.engine._prefill_last``'s
  forward): the prompt right-padded to its bucket, per-slot positions
  (padding at -1), a page table of the prompt's power-of-two page count
  over a pool of pages of 64;
- unpaged: the unpaged prefill (``serve.engine._prefill_rows``'s
  forward): the same window through the scalar-index forward over one
  slot's row of an 8-slot resident cache of ``max_seq_len`` positions
  (``serve.slots.slot_view``);
- fp32: the plain forward (``Transformer.forward``, no cache) of an fp32
  model holding the bf16 weights.

Each layer's error is max |x - x_fp32| over the prompt's positions,
over max |x_fp32|; the logits' is max |logit - logit_fp32| over max
|logit_fp32| at the last position, with whether the argmax agrees.
Prints one line a prompt and layer group, then a summary, and writes
``chiprun_out/bf16_partings.json``. Needs a CUDA device.

    python3 tests/torch_bf16_partings.py [N_PROMPTS]
"""

import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def prompts(n: int, seed: int) -> list:
    """The first ``n`` of phase 4's 24 prompts (its generator from
    ``seed``, in its order)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    system = rng.integers(0, 151643, 512).tolist()
    out = []
    for i in range(24):
        rng.integers(16, 257)  # the budget
        if i % 3 == 0:
            p = system + rng.integers(0, 151643,
                                      int(rng.integers(32, 989))).tolist()
        else:
            p = rng.integers(0, 151643, int(rng.integers(32, 1501))).tolist()
        out.append(p)
    return out[:n]


def traced(model, blocks, fn):
    """(each block's output [L, D] as fp32, the final hidden) of
    ``fn()`` run on ``model``, by forward hooks."""
    import torch

    seen = []
    hooks = [b.register_forward_hook(
        lambda _m, _a, out: seen.append(out[0].float().clone()))
        for b in blocks]
    try:
        with torch.no_grad():
            hidden = fn()
    finally:
        for h in hooks:
            h.remove()
    return seen, hidden[0]


def main(argv) -> int:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from tony_tpu_torch.models.generate import init_cache
    from tony_tpu_torch.models.transformer import Transformer
    from tony_tpu_torch.serve.engine import _bucket_pow2, bucket_len
    from tony_tpu_torch.serve.slots import paged_cache, slot_view

    torch.backends.cuda.matmul.allow_tf32 = False
    n_prompts = int(argv[0]) if argv else 6
    dev = cs.DEVICE
    cfg = cs.qwen_config(dtype=torch.bfloat16)
    bf = Transformer(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(cs.SEED))
    f32 = Transformer(dataclasses.replace(cfg, dtype=torch.float32),
                      device=dev)
    f32.load_state_dict(bf.state_dict())
    rows = init_cache(bf, 8)
    ps, results = 64, []
    for k, p in enumerate(prompts(n_prompts, cs.SEED)):
        n = len(p)
        lb = bucket_len(n, cfg.max_seq_len, 16)
        cols = min(_bucket_pow2(-(-n // ps)), -(-cfg.max_seq_len // ps))
        window = torch.zeros(1, lb, dtype=torch.long, device=dev)
        window[0, :n] = torch.tensor(p, device=dev)
        pos = torch.full((1, lb), -1, dtype=torch.long, device=dev)
        pos[0, :n] = torch.arange(n, device=dev)
        pool = paged_cache(bf, cols, ps)
        table = torch.arange(cols, device=dev)[None]
        ref, ref_h = traced(f32, f32.blocks, lambda: f32(
            window[:, :n], return_hidden=True))
        paths = {
            "paged": traced(bf, bf.blocks, lambda: bf(
                window, decode=True, positions=pos, page_table=table,
                cache=pool, return_hidden=True)),
            "unpaged": traced(bf, bf.blocks, lambda: bf(
                window, decode=True, cache=slot_view(rows, 3, 0),
                return_hidden=True))}
        ref_logit = f32.logits(ref_h[n - 1:n])[0]
        row = {"prompt": k, "tokens": n, "bucket": lb, "cols": cols}
        for name, (layers, hidden) in paths.items():
            row[name] = {
                "layers": [((x[:n] - r[:n]).abs().max()
                            / r[:n].abs().max()).item()
                           for x, r in zip(layers, ref)],
                "final": ((hidden[:n] - ref_h[:n]).abs().max()
                          / ref_h[:n].abs().max()).item()}
            logit = bf.logits(hidden[n - 1:n])[0]
            row[name]["logits"] = ((logit - ref_logit).abs().max()
                                   / ref_logit.abs().max()).item()
            row[name]["argmax_equal"] = bool(
                logit.argmax() == ref_logit.argmax())
        results.append(row)
        for name in paths:
            lay = row[name]["layers"]
            print(f"prompt {k} ({n} tokens, bucket {lb}, {cols} pages) "
                  f"{name}: layers 1/7/14/21/28 "
                  + " / ".join(f"{lay[i]:.3g}" for i in (0, 6, 13, 20, 27))
                  + f"; final {row[name]['final']:.3g}; last logits "
                  f"{row[name]['logits']:.3g} of max|logit|, argmax "
                  f"{'equal' if row[name]['argmax_equal'] else 'differs'}",
                  flush=True)
    summary = {}
    for name in ("paged", "unpaged"):
        summary[name] = {
            "final_mean": sum(r[name]["final"] for r in results)
            / len(results),
            "logits_mean": sum(r[name]["logits"] for r in results)
            / len(results),
            "layer_mean": [sum(r[name]["layers"][i] for r in results)
                           / len(results) for i in range(cfg.n_layers)]}
    farther = sum(r["unpaged"]["final"] > r["paged"]["final"]
                  for r in results)
    print(f"summary over {len(results)} prompts: final hidden error mean "
          f"paged {summary['paged']['final_mean']:.4g}, unpaged "
          f"{summary['unpaged']['final_mean']:.4g}; last logits mean paged "
          f"{summary['paged']['logits_mean']:.4g}, unpaged "
          f"{summary['unpaged']['logits_mean']:.4g}; unpaged farther from "
          f"fp32 in {farther} of {len(results)} prompts [{cs.card()}]")
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "bf16_partings.json"), "w") as f:
        json.dump({"card": cs.card(), "prompts": results,
                   "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
