#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, phase by phase; any failure
exits non-zero.

1. Build: compile every CUDA kernel of ``tony_tpu_torch/csrc`` with nvcc,
   one process a source, all at once; print each kernel's registers and
   spills, and for the tensor-core kernels (flash attention forward, dQ,
   dK/dV; flash-decode), every q8_matmul instance and the norms'
   one-pass instances at phase 9's widths their blocks per SM (and
   dynamic shared memory).
2. Kernel against its plain version: flash-decode at Qwen2.5-1.5B shapes
   (B=8, H=12, KVH=2, D=128, S in {64, 1024, 4096}; bf16, fp32 and int8
   caches; mixed lengths with a 0; a window; one MHA shape), held per
   element to ``decode_tolerance``, then timed beside the plain version,
   ``scaled_dot_product_attention`` (a yardstick the port never calls)
   and the bytes bound, each with the route it took (tensor cores or
   SIMT).
3. Model against its reference: Qwen2.5-1.5B at full width and depth,
   seeded random fp32 weights, a 200-token prompt prefilled through the
   page pool and 8 greedy decode steps on the paged view, held against
   the plain full forward, with the float and the int8 KV cache.
4. Serve: one Server (batch 8, paged, prefix store, flash-decode, bf16)
   answers 24 requests; every request must finish as its budget and the
   eos ids say, the store must hit, every decode chunk and prefill must
   be a CUDA-graph replay or the first call at its key (none eager),
   and the kernel must have launched n_layers times per decode
   micro-step, replays included; the captures, their seconds and the
   graphs' shared pool are printed, and the captures' seconds by part
   (``torch.cuda.graph``'s entry synchronize, ``gc.collect()``, cache
   flushes, the recording; also in 15a and 16a). An untimed second pass of 8 long
   requests: on one saved state, a chunk run eagerly and one replayed
   must give the same tokens and pool bytes (4b), both are timed, and
   the eager one keeps the largest flash-decode call for the kernel
   line; then the device's busy time under torch.profiler gives the
   host share with replays.
5. CLI: a 2-layer full-width checkpoint directory read by
   ``tony_tpu_torch.cli.generate --serve`` from a pipe; then in fp32
   with two repetitive prompts more, ``--speculate-k 4`` against the
   same run without it: equal responses.
6. Training kernels against their plain versions at Qwen2.5-1.5B shapes:
   flash attention forward, dQ and dK/dV at B=4, L=2048, H=12, KVH=2,
   D=128 in bf16 (the training path's call), and fp32 at L=1024, a
   512-key window, three packed segments, L=2047 and an MHA shape with
   D=64, each output held per element to ``ops.attention.error_bound``;
   fused AdamW over the model's whole 1.54 B-parameter leaf set (the
   grads' dtype phase 8 gives it, fp32 master and moments, bf16 copy),
   bit-equal to its plain version, with the wrapper's host time a call
   (its table cached, and built anew) and three rounds of the kernel and
   the library call in turn. Each kernel is timed beside its plain version, a PyTorch call that
   the port never makes (``scaled_dot_product_attention`` forward and
   backward, ``torch.optim.AdamW(fused=True)``) and its bound, with its
   achieved TFLOP/s at the training call; a second run of the bf16
   forward, dQ and dK/dV kernels must give the same bits.
7. Full-width gradient check: Qwen2.5-1.5B, 28 layers, fp32, 1 x 2048
   tokens, chunked cross-entropy; one forward and backward through the
   kernels and one through the plain versions, on the same weights.
8. Training through ``fit``: Qwen2.5-1.5B at full width and depth, bf16
   compute over fp32 masters, FusedAdamW with the carry and a learning
   rate of 3e-4 after a 4-step linear warmup (a tensor function of the
   count), remat ``attn_saved``, chunked CE (chunk 2048), micro-batch 4
   x accum 2 of 2048-token sequences from a DataLoader over 8 fixed
   sequences, 8 steps, the step captured whole as one CUDA graph (the
   first step eager then captured, the other 7 replays): losses finite
   and falling, launch counts as the config implies (replays included),
   tokens/s, ms/step, MFU, peak memory, the capture's seconds by part;
   then on one saved state (kept on the host) 3 steps replayed and 3
   eager: losses and masters bit-equal, each replay raising the flash
   attention and AdamW launch counts by one step's; each way's ms a
   step, tokens/s, MFU, peak memory and (from an untimed profiled step)
   host share.
9. int8 kernels against their plain versions: q8_matmul at the four
   (k, n) shapes of Qwen2.5-1.5B's seven projections, m in {1, 8, 4096},
   fp32 and bf16 x, and one ragged shape (257, 1000, 300), each output
   held per element to ``ops.quant.error_bound`` and a rerun bit-equal,
   with its route, grid and K splits, the achieved TB/s or TFLOP/s
   beside the bound and its device time by kernel from torch.profiler;
   rmsnorm and add_rmsnorm at 8 and 8192 rows of D=1536 and 4096 rows
   of D=4096 and 8192, bf16 and fp32, each held per element to
   ``norm_limit`` with ``summed`` and a rerun bit-equal, with its launch
   plan and its kernel time from torch.profiler beside the events. Each
   is timed beside its plain version, one PyTorch call the port never
   makes (``torch._weight_int8pack_mm`` where it runs, else ``F.linear``
   on weights dequantized ahead of time; ``F.rms_norm``) and its bound;
   rmsnorm also beside a ``copy_`` of its bytes, what this timing lets
   the card reach.
10. int8 model: Qwen2.5-1.5B at full width and depth, seeded random fp32
   weights converted by ``quantize_for_serving``, prefill of 8 x 512
   tokens and 16 teacher-forced decode steps with fp32 activations and
   with bf16 activations (the same int8 state_dict in a bf16 config),
   each row of logits held against the plain q8_matmul route; 7 x 28
   kernel launches a forward. The fused norms, public ops no model path
   calls, are driven on the model's embedded tokens and held against
   its RMSNorm module.
11. int8 generation: ``generate`` at batch 8, 512-token prompts, 128
   greedy tokens, on the int8 model (bf16 activations) and on phase 4's
   bf16 model, its decode step replayed as a CUDA graph (every step
   after the warm-up's first a replay) and launched eagerly, the tokens
   equal: tokens/s, ms a decode step, q8_matmul's launches by route
   (decode steps on the decode route, replays included, prefills on the
   tensor cores), and the host share and device busy time a step, each
   way, from an untimed profiled probe.
12. int8 CLI: over a 2-layer full-width checkpoint, ``cli.generate
   --int8 --token-ids``, ``cli.score --int8`` and ``cli.score``; the
   int8 nll/token within 5% of the fp32 one; ``--serve --int8`` refused.
13. Serving options, each on phase 4's configuration (a fresh Server a
   part; every run held to ``check_run``: requests finished as budget
   and eos say, no page leaked, flash-decode n_layers times a
   single-token micro-step, every chunk, verify round, prefill and
   prefill chunk a capture or a replay):
   a. speculation: 16 greedy requests (a 5-16-token pattern repeated to
      256-1024 tokens, budgets 64-256) with ``speculate_k`` 8, then
      with 0: tok/s, rounds, drafts and acceptance; the streams equal,
      or parting only at a near tie (``near_ties``: one plain forward
      over the common prefix puts both tokens' logits within 2^-6 of
      the row's largest |logit|);
   b. on one saved pool state a verify round replayed and eager:
      emit, accepted, cont and pool bytes bit-equal, both timed;
   c. chunked prefill: four 3000-token prompts ahead of twelve of
      32-256 tokens, with 512-token chunks and without: the short
      requests' TTFT, the chunk graphs, near-tie equal streams; and a
      512-token window timed with and without the LM head;
   d. speculation with in-dispatch EOS off: streams near-tie equal to
      13a's, wasted and frozen steps beside 13a's;
   e. ``FaultPlan.fail_at(3)``: ``InjectedFault`` out of ``step()``
      with 8 requests live, ``reset()`` leaving only the prefix store's
      pages, the 16 requests again token-equal to 13a's.
14. Unpaged and sliding-window serving (every run held to ``check_run``;
   unpaged, each chunk and verify round a capture or a replay and each
   prefill one eager call):
   kernel. flash-decode at Mistral-7B's windowed call (B=8, H=32,
      KVH=8, D=128, S=8192, window 4096, lengths 4200-6000, bf16),
      held to ``decode_tolerance``, timed beside its plain version,
      SDPA with the window mask and its bound;
   a. Mistral-7B-v0.1 at full width and depth (published config,
      ``max_seq_len`` 8192, seeded random bf16 weights) through
      ``Server(paged=None)``, asserted unpaged: batch 8, chunks of up to
      8, flash-decode, no prefix store; 16 greedy requests (8 prompts of
      4200-6000 tokens, 8 of 64-1024, budgets 64-256): tok/s, TTFT,
      seconds capturing, eager prefills, peak memory; two streams held
      to greedy decoding by the plain full forward (teacher-forced,
      window mask) by the near-tie rule;
   b. 14a's traffic with 1024-token prefill chunks: streams near-tie
      equal to 14a's, peak memory beside it;
   c. Qwen2.5-1.5B (phase 4's weights) ``paged=False`` with a 1 GB row
      prefix store at phase 4's traffic: prefix hits, tok/s and TTFT
      beside phase 4's, and where its bf16 streams part from phase 4's
      (printed: the two paths round differently in bf16); the first 12
      of those requests in fp32, paged and unpaged: every stream equal;
      four prompts served twice (the second time exact hits, near-tie
      equal); ``speculate_k`` 8 at the first 8 of 13a's requests
      (unpaged verify rounds replayed);
   d. on one saved resident-cache state, an unpaged chunk replayed and
      eager: tokens and cache bytes bit-equal, both timed;
   e. ``generate`` at batch 2, 512-token prompts, 64 tokens, with
      ``repetition_penalty`` 1.3 (replayed equal to eager; 1.0 equal to
      none) and ``beam_search`` (``num_beams`` 1 near-tie equal to
      greedy; 4 timed);
   f. the CLI: ``--serve`` over a 2-layer full-width Mistral checkpoint
      (unpaged and no prefix store, with their notes); over phase 5's
      checkpoint ``--no-paged-kv`` equal to paged in fp32, one-shot
      ``--num-beams 4`` and ``--repetition-penalty 1.3``.
15. The gateway (``tony_tpu_torch.gateway``), in process:
   a. two replicas of phase 4's serving configuration (the same seeded
      bf16 weights, shared) behind ``GatewayEdge`` on ``127.0.0.1:0``,
      started cold, so that both replicas capture their first graphs in
      the same run; phase 4's 24 requests sent at once by 24 HTTP
      clients, every second one streamed as NDJSON: every response 200,
      each stream equal to phase 4's or parting at a near tie,
      flash-decode launched n_layers times a micro-step of both
      replicas, replays included; ``/stats`` with each replica's goodput
      ledger (every kind's HBM-BW% within 0-100) and ``/metrics`` with
      ``tony_goodput_fraction``; tok/s and TTFT (the gateway's per-request
      metric, submit to first token) beside phase 4's, seconds capturing
      and each replica's capture window, the goodput buckets; then the
      same traffic twice warm, unprofiled (wall, tok/s) and under
      torch.profiler (the device's busy time): the host share;
   b. ``python -m tony_tpu_torch.cli.gateway --model <phase 5's
      checkpoint> --replicas 2 --port 0 --dtype fp32`` as a subprocess:
      phase 5's requests over HTTP, each stream equal to one fp32
      ``Server``'s on the same checkpoint, then SIGTERM: a drain and
      exit 0.

16. Sampled serving and generation, all through replayed graphs:
   a. phase 4's configuration and 24 requests, every second one sampled
      (temperature 0.8, top-k 50 on half of those and none on the
      others, a seed each), cold and then warm: every chunk a capture or
      a replay (none eager) and ``check_run``; tok/s, TTFT and seconds
      capturing beside phase 4's; the greedy requests' streams equal
      phase 4's or parting at a near tie; each sampled request served
      alone equal to its stream in the mix, or parting at a near tie of
      its draw (``sampled_parting``);
   b. with speculation on, on one saved state (pool and keys), a sampled
      chunk and a sampled verify round each replayed and eager: tokens,
      keys and pool bytes bit-equal; both timed, beside the greedy
      variant of the chunk, and the sampler's device time a micro-step;
   c. ``generate`` with temperature 0.8, top-k 50 and top-p 0.9 at batch
      8, 512-token prompts, 128 tokens, replayed and eager from one
      generator state: tokens bit-equal; tok/s beside phase 11's greedy.

17. Remote replicas and the KV fabric: phase 4's model written to a
   checkpoint directory (``max_position_embeddings`` 4096, the end-of-text
   ids) and read back by ``python -m tony_tpu_torch.cli.replica`` agents
   (bf16, batch 8, pages of 64, a 64 MB prefix store, flash-decode),
   two of them, and two more over phase 5's 2-layer checkpoint in fp32,
   all four booting at once:
   a. the two bf16 agents behind a ``Gateway`` of ``RemoteServer``s, cold,
      phase 4's 24 requests: tok/s, TTFT p50/p99, each agent's seconds
      capturing, peak memory and flash-decode launches (read from the
      agent, n_layers a single-token micro-step, replays included);
      streams near-tie equal to phase 4's;
   c. (bf16) a greedy and a sampled stream (512-token prompt, budget
      768) each moved to the other agent by ``Gateway.migrate_session``
      after 64 tokens: freeze-to-resume ms, pages and bytes moved, the
      gateway's host spans; each near-tie equal to the same request
      unmoved (the sampled one by the rule of a draw); after 17d the move
      in parts, with the source agent in this process, idle and busy;
   b. roles prefill=1, decode=1 over the same two agents, phase 4's
      traffic: handoffs, each request's payload bytes and pages on the
      wire, TTFT, tok/s, streams near-tie equal to phase 4's, no
      flash-decode launch on the prefill agent; in fp32 on
      the 2-layer checkpoint, requests one at a time, the split's streams
      equal one ``Server``'s and a greedy and a sampled stream migrated
      after 16 tokens equal the unmigrated ones, token for token;
   d. one in-process ``Server`` with an 8 MB prefix store and
      ``kv_host_mb`` 512: six distinct 192-token prompts evict each
      other into the tier, then each returns extended by 64 tokens and
      pages its prefix back in: spills, page-ins, prefix hits, each
      paged-in page bit-equal to the spilled one, streams near-tie equal
      to the run without the tier (checked after the timed runs), TTFT
      beside it, host spans of the page-in and the spill;
   e. ``python -m tony_tpu_torch.cli.gateway --model <phase 5's
      checkpoint> --remote-replica --replicas 2 --dtype fp32``: two agent
      processes that launch flash-decode, phase 5's requests over HTTP
      token-exact to one fp32 ``Server``, SIGTERM drains to exit 0 and
      nothing is left of the gateway's process group.
18. A job on the card, through the port's control plane as a user submits
   one: ``python -m tony_tpu_torch.cli.local`` (client, coordinator,
   agent) running ``tony_tpu_torch/examples/lm_pretrain.py`` on one
   worker with ``tony.worker.chips=1``; this script's cached memory is
   released first and the card's free memory printed. Each job's process
   tree is sampled from /proc every 0.25 s: the payload's own pid must
   hold the card (an open /dev/nvidia* file) and no other job process
   may, apart from the agent's nvidia-smi readings (nvidia-smi reports
   every process as pid 1 on this machine, so its compute-process list
   is counted, not matched by pid); no process may run the JAX package.
   a. Qwen2.5-1.5B at full size, phase 8's recipe, batch and length, 8
      steps: SUCCEEDED with a finished history, the payload saw
      ``CUDA_VISIBLE_DEVICES=0``, each training kernel launched in its
      process (printed on a line of its own), losses bit-equal to phase
      8's; its ms a step and MFU beside phase 8's, and the wall from
      submit to SUCCEEDED split into staging, coordinator start, agent
      registration, payload start, to the end of step 2, training and
      teardown;
   b. the same width at 2 layers with a checkpoint dir,
      ``tony.coordinator.retry-count=1`` and ``--fail-after-checkpoint
      4``: attempt 0 exits 1, attempt 1 resumes at step 4, the job
      SUCCEEDS, and its last loss and every fp32 master are bit-equal to
      an uninterrupted 8-step run in this process; the checkpoint's
      bytes, save and restore seconds;
   c. a payload that only runs ``torch.ones(1, device="cuda")``, with
      ``tony.worker.memory=64g`` (the launcher's ``RLIMIT_AS``) and
      without: the one without must succeed, the other is a reading.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches (flash-decode's include 16a's
replays, the training kernels' phase 8's, and phase 17's agents'),
error and times.

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import glob
import io
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, same source
SEED = 0
DEVICE = "cuda"

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
SERVE_MAX_LEN = 4096  # the smoke's serving cap (published: 131072)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def cuda_time_ms(fn, reps: int, flush) -> float:
    """Median device time of ``fn`` over ``reps`` calls, by CUDA events.
    Before each call the 50 MB L2 cache is flushed (the decode path finds
    it cold: the other layers' weights and caches pass through it between
    calls) and the device is held busy for about 1 ms, so the host has
    enqueued all of ``fn`` before the start event fires and the interval
    is device time, not Python launch overhead."""
    import torch

    times = []
    for _ in range(reps + 2):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[2:])


def kernel_breakdown(fn, reps: int, flush, mark: str) -> dict:
    """{kernel: (device us a call, launches a call)} of the kernels whose
    name holds ``mark``, from ``cuda_time_ms`` run under torch.profiler
    (device activity only): splits an event time into its kernels and
    the gaps between them. Empty when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cuda_time_ms(fn, reps, flush)
    calls = reps + 2  # cuda_time_ms's calls, the two warm ones included
    out = {}
    for r in prof.key_averages():
        us = getattr(r, "self_device_time_total",
                     getattr(r, "self_cuda_time_total", 0.0))
        if mark in r.key and us > 0:
            name = re.search(r"\w*" + re.escape(mark) + r"\w*",
                             r.key).group(0)
            t, n = out.get(name, (0.0, 0.0))
            out[name] = (t + us / calls, n + r.count / calls)
    return out


def decode_bound(q, k, length, window: int) -> tuple[float, str]:
    """Least time for flash-decode on these inputs: the bytes it must
    move (q, the visible K/V rows and their int8 scales, lengths, out)
    over HBM bandwidth, against 4 flops per visible (key, query head,
    dim) over the peak rate for the query's type."""
    h, d = q.shape[1], q.shape[2]
    s, kvh = k.shape[1], k.shape[2]
    lens = length.clamp(0, s).long()
    start = (lens - window).clamp(min=0) if window > 0 else 0 * lens
    visible = int((lens - start).sum())
    scales = 2 * visible * kvh * 4 if not k.dtype.is_floating_point else 0
    nbytes = 2 * visible * kvh * d * k.element_size() + scales \
        + 2 * q.numel() * q.element_size() + length.numel() * 4
    ops = 4 * visible * h * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[str(q.dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_yardstick(q, k, v, length, window, k_scale, v_scale):
    """One ``scaled_dot_product_attention`` call computing the same
    function on the same (dequantized) inputs — timed, never used."""
    import torch
    import torch.nn.functional as F

    b, h, d = q.shape
    s = k.shape[1]
    if k_scale is not None:
        k = (k.float() * k_scale[..., None]).to(q.dtype)
        v = (v.float() * v_scale[..., None]).to(q.dtype)
    kt = k.permute(0, 2, 1, 3)
    vt = v.permute(0, 2, 1, 3)
    pos = torch.arange(s, device=q.device)[None, :]
    ln = length[:, None].long()
    mask = pos < ln
    if window > 0:
        mask = mask & (pos >= (ln - window).clamp(min=0))
    mask = mask[:, None, None, :]

    def run():
        return F.scaled_dot_product_attention(
            q[:, :, None, :], kt, vt, attn_mask=mask,
            enable_gqa=kt.shape[1] != h)

    return run


def decode_tolerance(q, vmax: float) -> tuple[float, float]:
    """(rtol, atol) for flash-decode against its plain version, per
    output element: |got - want| <= rtol * |want| + atol. Both sum in
    fp32 in a different order (atol 1e-5 * max|v|, the fp32 limit), and
    a bf16 output may then round to the neighbouring bf16 value (rtol
    2^-7, one bf16 step of the element itself)."""
    import torch

    return (0.0 if q.dtype == torch.float32 else 2.0 ** -7), 1e-5 * vmax


def measure_decode(q, k, v, length, window, k_scale, v_scale, flush,
                   reps=20) -> dict:
    """Kernel against plain version on one input set: the error, held
    to ``decode_tolerance`` before anything is timed, then the times."""
    import torch

    from tony_tpu_torch.ops.decode import (flash_decode,
                                           flash_decode_reference, plan)

    kw = dict(window=window, k_scale=k_scale, v_scale=v_scale)
    tc, nsplit = plan(q, k, window)
    vmax = (v.float() * v_scale[..., None] if v_scale is not None
            else v.float()).abs().max().item()
    inputs = [t for t in (q, k, v, length, k_scale, v_scale)
              if torch.is_tensor(t)]
    before = [t.clone() for t in inputs]
    got = flash_decode(q, k, v, length, **kw)
    sync()
    check(all(torch.equal(a, b) for a, b in zip(inputs, before)),
          "the kernel wrote into its inputs")
    want = flash_decode_reference(q, k, v, length, **kw)
    sync()
    check(bool(torch.isfinite(got).all()), "kernel output not finite")
    diff = (got.float() - want.float()).abs()
    rtol, atol = decode_tolerance(q, vmax)
    excess = (diff - rtol * want.float().abs()).max().item()
    err = diff.max().item()
    check(excess <= atol,
          f"flash_decode {k.dtype} cache, q {q.dtype}, S={k.shape[1]} "
          f"window={window}: |got - want| exceeds {rtol:.3g} * |want| by "
          f"{excess:.3g} > {atol:.3g} (max abs err {err:.3g}; per-row "
          f"{diff.amax(dim=(1, 2)).tolist()})")
    zero_rows = (length == 0).nonzero().flatten().tolist()
    for r in zero_rows:
        check(bool((got[r] == 0).all()), f"row {r} (length 0) not zeros")
    kernel_ms = cuda_time_ms(lambda: flash_decode(q, k, v, length, **kw),
                             reps, flush)
    plain_ms = cuda_time_ms(
        lambda: flash_decode_reference(q, k, v, length, **kw), reps, flush)
    library_ms = cuda_time_ms(
        sdpa_yardstick(q, k, v, length, window, k_scale, v_scale), reps,
        flush)
    bound_ms, bound_by = decode_bound(q, k, length, window)
    return {"max_abs_err": err, "excess": excess, "rtol": rtol,
            "atol": atol, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "nsplit": nsplit,
            "route": "tensor cores" if tc else "SIMT"}


def decode_by_split(q, k, v, length, window, k_scale, v_scale, flush,
                    splits, reps=20) -> dict:
    """{nsplit: kernel ms} for one input set, each split count launched
    through the C entry point as the wrapper launches it (the wrapper's
    own rule picks one of them)."""
    import torch

    from tony_tpu_torch.ops import decode as dec

    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    out = torch.empty_like(q)
    lengths = length.to(torch.int32).contiguous()
    res = {}
    for n in splits:
        ml = torch.empty(b * kvh * n * g * 2, dtype=torch.float32,
                         device=q.device)
        acc = torch.empty(b * kvh * n * g * d, dtype=torch.float32,
                          device=q.device)

        def run():
            err = dec._kernel()(
                dec._DTYPE_CODES[k.dtype], dec._DTYPE_CODES[q.dtype],
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if k_scale is None else k_scale.data_ptr(),
                None if v_scale is None else v_scale.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), ml.data_ptr(),
                acc.data_ptr(), b, h, kvh, s, d, int(window),
                float(d ** -0.5), n, torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"flash_decode at nsplit={n}: CUDA error {err}")

        res[n] = cuda_time_ms(run, reps, flush)
    return res


# ----------------------------------------------------------------- phases


def ptxas_entries(report: str) -> dict:
    """{mangled kernel name: [ptxas lines]} from an ``-Xptxas -v`` report:
    the registers line and the stack/spill line of each entry."""
    entries, entry = {}, ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif entry and ("Used" in line or "spill" in line):
            entries.setdefault(entry, []).append(
                line.split(":", 1)[-1].strip())
    return entries


def phase_build(ctx) -> None:
    import torch

    from tony_tpu_torch.ops import _build, fused
    from tony_tpu_torch.ops.attention import kernel_resources
    from tony_tpu_torch.ops.decode import \
        kernel_resources as decode_resources
    from tony_tpu_torch.ops.quant import kernel_resources as q8_resources

    t0 = time.perf_counter()
    _build.build_all()
    ctx["build_s"] = time.perf_counter() - t0
    for name in _build.sources():
        _build.load(name)
        for entry, info in ptxas_entries(
                _build.ptxas_report.get(name, "")).items():
            if "norm_onepass" not in entry:  # its instances: below
                print(f"  {name}: {entry[:72]}: {'; '.join(info)}")
    print(f"phase 1 build: {len(_build.sources())} source(s) in "
          f"{ctx['build_s']:.1f} s (nvcc, sm_90a)")
    # the tensor-core kernels: ptxas's registers and spills, the dynamic
    # shared memory and how many blocks fit on an SM
    entries = ptxas_entries(_build.ptxas_report.get("flash_attention", ""))
    for (kern, d), r in kernel_resources().items():
        info = ["; ".join(v) for e, v in entries.items()
                if f"{kern}_kernel_tcILi{d}E" in e]
        print(f"phase 1 {kern}_kernel_tc<{d}> (bf16, mma.sync): "
              f"{info[0] if info else 'ptxas report not captured (built before)'}"
              f"; {r['smem']} B dynamic shared memory, {r['blocks']} "
              f"block(s) of 128 threads per SM")
    entries = ptxas_entries(_build.ptxas_report.get("flash_decode", ""))
    for (cache, d), r in decode_resources().items():
        mangled = "13__nv_bfloat16" if cache == "bf16" else "a"
        info = ["; ".join(v) for e, v in entries.items()
                if f"flash_decode_tcI{mangled}Li{d}E" in e]
        print(f"phase 1 flash_decode_tc<{cache}, {d}> (bf16 q, mma.sync): "
              f"{info[0] if info else 'ptxas report not captured (built before)'}"
              f"; {r['smem']} B dynamic shared memory, {r['blocks']} "
              f"block(s) of 128 threads per SM")
    # the norms' one-pass instances at the smoke's widths: registers,
    # spills and blocks an SM
    entries = ptxas_entries(_build.ptxas_report.get("fused_norms", ""))
    mangled = {torch.float32: "f", torch.bfloat16: "13__nv_bfloat16"}
    for d in sorted({d for _, d in NORM_CALLS}):
        for (xd, rd), blocks in fused.kernel_resources(d).items():
            p = fused.plan(8192, d, xd, rd, 1)
            rt = "f" if rd in (None, torch.float32) else "S1_"
            key = (f"norm_onepassI{mangled[xd]}{rt}Lb{int(rd is not None)}"
                   f"ELi{p.lane_vectors}EE")
            info = ["; ".join(v) for e, v in entries.items() if key in e]
            print(f"phase 1 {'add_rmsnorm' if rd else 'rmsnorm'} "
                  f"<{str(xd)[6:]}> D={d} ({p.row_warps} warp(s) a row x "
                  f"{p.lane_vectors} vectors a lane): "
                  f"{info[0] if info else 'ptxas report not captured (built before)'}"
                  f"; {blocks} block(s) of {p.block_rows * p.row_warps * 32} "
                  f"threads per SM")
    # q8_matmul's instances (bf16 output): the decode route per x dtype
    # and row count, the tensor-core route and the SIMT tile
    entries = ptxas_entries(_build.ptxas_report.get("q8_matmul", ""))
    for (route, dt, rows), r in q8_resources().items():
        kern = (f"q8_decode_kernelI13__nv_bfloat16Li{rows}EE"
                if dt == torch.float32 else
                f"q8_decode_tc_kernelI13__nv_bfloat16Li{rows // 8}EE")
        name, key = {
            0: (f"decode<{str(dt)[6:]} x, {rows} rows>", kern),
            1: ("tensor cores<bf16 x>", "q8_tc_kernelI13__nv_bfloat16E"),
            2: ("SIMT tile<fp32 x>",
                "q8_matmul_kernelIf13__nv_bfloat16Li128ELi128ELi32E"),
        }[route]
        info = ["; ".join(v) for e, v in entries.items() if key in e]
        print(f"phase 1 q8_matmul {name} (bf16 out): "
              f"{info[0] if info else 'ptxas report not captured (built before)'}"
              f"; {r['smem']} B dynamic shared memory, {r['blocks']} "
              f"block(s) of 256 threads per SM")


def phase_kernel(ctx) -> None:
    import torch

    from tony_tpu_torch.ops.decode import quantize_kv

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    flush = ctx["flush"]
    rows = []
    shapes = [(12, 2, s) for s in (64, 1024, 4096)] + [(12, 12, 1024)]
    for h, kvh, s in shapes:
        for cache in ("bf16", "fp32", "int8"):
            for window in (0, 48):
                if window and (kvh != 2 or s != 1024):
                    continue
                b, d = 8, 128
                q = torch.randn(b, h, d, device=DEVICE, generator=gen)
                k = torch.randn(b, s, kvh, d, device=DEVICE, generator=gen)
                v = torch.randn(b, s, kvh, d, device=DEVICE, generator=gen)
                lens = [0, 1, s // 3, s // 2, s - 7, s - 1, s, s // 5 + 3]
                length = torch.tensor(lens, dtype=torch.int32,
                                      device=DEVICE).clamp(0, s)
                ks = vs = None
                qdt = torch.float32 if cache == "fp32" else torch.bfloat16
                q = q.to(qdt)
                if cache == "int8":
                    k, ks = quantize_kv(k)
                    v, vs = quantize_kv(v)
                else:
                    k, v = k.to(qdt), v.to(qdt)
                m = measure_decode(q, k, v, length, window, ks, vs, flush)
                rows.append({"cache": cache, "H": h, "KVH": kvh, "S": s,
                             "window": window, **m})
                print(f"phase 2 flash_decode B=8 H={h} KVH={kvh} D=128 "
                      f"S={s} {cache} window={window} ({m['route']}, "
                      f"{m['nsplit']} split(s)): max abs err "
                      f"{m['max_abs_err']:.3g} (tol {m['rtol']:.3g}*|want| "
                      f"+ {m['atol']:.3g}, worst excess {m['excess']:.3g});"
                      f" kernel {m['ms'] * 1e3:.1f} us, plain "
                      f"{m['plain_ms'] * 1e3:.1f} us, sdpa "
                      f"{m['library_ms'] * 1e3:.1f} us, bound "
                      f"{m['bound_ms'] * 1e3:.2f} us ({m['bound_by']}) "
                      f"[{ctx['card']}]")
    ctx["kernel_rows"] = rows


def qwen_config(**overrides):
    from tony_tpu_torch.models.hf import llama_config

    return llama_config(QWEN25_15B, max_seq_len=SERVE_MAX_LEN,
                        decode_attention="flash", **overrides)


def phase_model(ctx) -> None:
    import torch

    import tony_tpu_torch.models.transformer as tmod
    from tony_tpu_torch.models.generate import (multi_decode_step,
                                                single_decode_step)
    from tony_tpu_torch.models.transformer import Transformer
    from tony_tpu_torch.ops.decode import dequantize_kv, quantize_kv
    from tony_tpu_torch.serve.slots import paged_cache, paged_view

    cfg = qwen_config(dtype=torch.float32)
    base = Transformer(cfg, device=DEVICE).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (200,), device=DEVICE,
                           generator=gen)
    ps, n_steps = 64, 8
    plain_attention = tmod.reference_attention

    def int8_kv_attention(q, k, v, **kw):
        # the int8 cache's values: K/V quantized per (position, head)
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return plain_attention(q, dequantize_kv(kq, ks).to(k.dtype),
                               dequantize_kv(vq, vs).to(v.dtype), **kw)

    # fp32: reordered fp32 sums over 28 layers. int8: the two paths
    # compute K/V in differently shaped GEMMs, and a 1e-7 difference
    # flips a value sitting on an int8 rounding boundary by one step
    # (1/127 of its row's absmax)
    for quant, rel_tol in ((False, 2e-3), (True, 5e-2)):
        model = base
        if quant:
            model = Transformer(dataclasses.replace(cfg,
                                                    kv_cache_quant=True),
                                device=DEVICE)
            model.load_state_dict(base.state_dict())
        pool = paged_cache(model, 8, ps)
        table = torch.tensor([[5, 2, 7, 0]], device=DEVICE)
        window = torch.zeros(1, 256, dtype=torch.long, device=DEVICE)
        window[0, :200] = prompt
        pos = torch.full((1, 256), -1, dtype=torch.long, device=DEVICE)
        pos[0, :200] = torch.arange(200, device=DEVICE)
        pool, logits = multi_decode_step(model, pool, window, pos, table)
        cached = [logits[0, :200]]
        view = paged_view(pool, table, cfg.max_seq_len)
        tok = int(torch.argmax(logits[0, 199]))
        fed = []
        for i in range(n_steps):
            fed.append(tok)
            view, last = single_decode_step(
                model, view, torch.tensor([tok], device=DEVICE),
                positions=torch.tensor([200 + i], device=DEVICE))
            cached.append(last)
            tok = int(torch.argmax(last[0]))
        cached = torch.cat(cached)
        seq = torch.cat([prompt, torch.tensor(fed, device=DEVICE)])[None]
        with torch.no_grad():
            plain = model(seq)[0]
            ref = plain
            if quant:
                tmod.reference_attention = int8_kv_attention
                try:
                    ref = model(seq)[0]
                finally:
                    tmod.reference_attention = plain_attention
        check(cached.shape == ref.shape == (208, cfg.vocab_size),
              f"logits shape {tuple(cached.shape)}")
        check(bool(torch.isfinite(cached).all()), "cached logits not finite")
        err = (cached - ref).abs().max().item()
        std = ref.std().item()
        name = "int8" if quant else "fp32"
        check(err <= rel_tol * std,
              f"{name} cache: cached-path logits differ from the full "
              f"forward by {err:.3g} > {rel_tol} * std {std:.3g}")
        drift = (cached - plain).abs().max().item()
        print(f"phase 3 Qwen2.5-1.5B fp32 {cfg.n_layers} layers, {name} KV "
              f"cache: prefill 200 + {n_steps} greedy steps, max abs err "
              f"{err:.3g} vs the full forward on the same K/V values (tol "
              f"{rel_tol} * std {std:.3g}); {drift:.3g} "
              f"({drift / std:.3g} std) vs the unquantized full forward")
        del pool, view, model
    del base
    torch.cuda.empty_cache()


def serve_timed(srv, reqs) -> dict:
    """Submit ``reqs`` at once and step ``srv`` until all finish, timed on
    the host from a synchronised start to a synchronised end, with
    flash-decode's launch count set to 0 just before: the Results by
    id, the wall seconds, each request's first-token time (the end of
    the step that gave it) and the launches."""
    from tony_tpu_torch.ops.decode import flash_decode

    results, first = {}, {}
    flash_decode.launches = 0
    sync()
    t0 = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    while not srv.done:
        for r in srv.step():
            results[r.id] = r
        now = time.perf_counter() - t0
        for rid in list(srv.live_progress()) + list(results):
            first.setdefault(rid, now)
    sync()
    return {"results": results, "wall": time.perf_counter() - t0,
            "first": first, "launches": flash_decode.launches}


def percentiles(values) -> tuple[float, float]:
    """(p50, p99) of ``values`` by rank."""
    v = sorted(values)
    return v[len(v) // 2], v[min(len(v) - 1, int(0.99 * len(v)))]


def check_run(srv, reqs, run, part: str, base: dict | None = None) -> dict:
    """What every serving run must show: every request finished as its
    budget and the eos ids say; no page reservation left and no page
    held but the prefix store's (paged); no frozen row that re-emitted
    another token; flash-decode launched n_layers times for each
    single-token micro-step (chunks and verify continuations; a verify
    window runs none); and, all requests greedy, every decode chunk,
    verify round, prefill and intermediate prefill chunk the first call
    at its key or a replay, none eager; unpaged, every chunk and verify
    round so, and every prefill (chunks included) one eager call.
    ``base`` = the counters before the run, for a server that served
    before it. Returns the run's counters."""
    c = srv.counters()
    base = base or {}

    def d(key):
        return c[key] - base.get(key, 0)

    results = run["results"]
    check(len(results) == len(reqs),
          f"{part}: {len(results)} of {len(reqs)} requests finished")
    eos = srv.eos_ids
    for r in reqs:
        res = results[r.id]
        toks = res.tokens
        hit = [j for j, t in enumerate(toks) if t in eos]
        if res.finish_reason == "eos":
            check(hit == [len(toks) - 1] and len(toks) <= r.max_new_tokens,
                  f"{part} request {r.id}: eos finish with tokens "
                  f"{toks[-3:]}")
        else:
            check(res.finish_reason == "length" and not hit
                  and len(toks) == r.max_new_tokens,
                  f"{part} request {r.id}: {res.finish_reason} after "
                  f"{len(toks)} of {r.max_new_tokens} tokens")
    if srv.paged:
        pinned = len({p for e in srv.prefix._entries.values()
                      for p in e.pages}) if srv.prefix is not None else 0
        check(c["kv_pages_reserved"] == 0
              and c["kv_pages_used"] == pinned,
              f"{part}: {c['kv_pages_reserved']} pages reserved and "
              f"{c['kv_pages_used']} used at the end, {pinned} pinned by "
              "the prefix store")
    check(c["freeze_faults"] == 0, f"{part}: frozen slots re-emitted "
          "other tokens")
    micro = d("decode_steps") - d("spec_window_steps")
    layers = srv.model.cfg.n_layers
    check(run["launches"] == layers * micro > 0,
          f"{part}: flash_decode launched {run['launches']} times, "
          f"expected {layers} x {micro} single-token micro-steps")
    intermediate = d("prefill_chunk_dispatches") \
        - d("prefill_chunked_requests")
    calls = (("decode", d("dispatches") - d("spec_rounds")),
             ("verify", d("spec_rounds")),
             ("prefill", d("prefills") - intermediate),
             ("prefill_chunk", intermediate))
    if not srv.paged:
        calls = (("chunk_rows", calls[0][1]), ("verify_rows", calls[1][1]))
        check(d("graph_prefill_rows_eager") == d("prefills"),
              f"{part}: {d('graph_prefill_rows_eager')} eager prefill "
              f"calls of {d('prefills')} prefills")
    for kind, total in calls:
        caps, reps = d(f"graph_{kind}_captures"), d(f"graph_{kind}_replays")
        check(d(f"graph_{kind}_eager") == 0 and caps + reps == total,
              f"{part} {kind}: {caps} captures + {reps} replays + "
              f"{d(f'graph_{kind}_eager')} eager of {total} calls")
    return c


SERVE_EOS = (151643, 151645)  # the Qwen2.5 tokenizer's end-of-text ids


def serve_server(model, **options):
    """Phase 4's serving configuration with ``options``: batch 8, pages of
    64, prefix store 64 MB, chunks of up to 8 micro-steps, the published
    end-of-text ids."""
    from tony_tpu_torch.serve import Server

    options = {"prefix_cache_mb": 64.0, **options}
    return Server(model, batch_size=8, eos_id=SERVE_EOS, chunk_steps=8,
                  device=DEVICE, **options)


def phase_serve(ctx) -> None:
    import numpy as np
    import torch

    from tony_tpu_torch.models.transformer import Transformer
    from tony_tpu_torch.serve import Request

    cfg = qwen_config(dtype=torch.bfloat16)
    model = Transformer(cfg, device=DEVICE).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    srv = serve_server(model)
    rng = np.random.default_rng(SEED)
    system = rng.integers(0, 151643, 512).tolist()
    reqs = []
    for i in range(24):
        budget = int(rng.integers(16, 257))
        if i % 3 == 0:  # 8 requests share the 512-token system prompt
            n = int(rng.integers(32, 989))
            prompt = system + rng.integers(0, 151643, n).tolist()
        else:
            n = int(rng.integers(32, 1501))
            prompt = rng.integers(0, 151643, n).tolist()
        reqs.append(Request(prompt, budget, id=i))

    # the timed run: serving work only (no profiler, no kernel-argument
    # capture; the graphs' first calls and captures are inside it)
    run = serve_timed(srv, reqs)
    c = check_run(srv, reqs, run, "phase 4")
    launches, wall = run["launches"], run["wall"]
    check(c["prefix_hits"] > 0, "the prefix store recorded no hit")
    check(c["graph_decode_replays"] > 0 and c["graph_prefill_replays"] > 0,
          "phase 4: no chunk or no prefill was replayed")
    pool = srv.graphs.pool_bytes()
    gen_tokens = sum(len(res.tokens) for res in run["results"].values())
    p50, p99 = percentiles(run["first"][r.id] for r in reqs)
    print(f"phase 4 serve Qwen2.5-1.5B bf16 {cfg.n_layers} layers, batch 8, 24 "
          f"requests: {gen_tokens} tokens in {wall:.2f} s = "
          f"{gen_tokens / wall:.1f} tok/s; TTFT p50 {p50:.3f} s, p99 "
          f"{p99:.3f} s; {c['decode_steps']} micro-steps in "
          f"{c['dispatches']} chunks, {c['prefills']} prefills, prefix "
          f"hits {c['prefix_hits']} ({c['prefix_hit_tokens']} tokens); "
          f"flash_decode launches {launches} = {cfg.n_layers} x "
          f"{c['decode_steps']} [{ctx['card']}]")
    print(f"phase 4 graphs: {c['graph_decode_captures']} chunk keys "
          f"captured, {c['graph_decode_replays']} chunk replays; "
          f"{c['graph_prefill_captures']} prefill keys captured, "
          f"{c['graph_prefill_replays']} prefill replays; 0 eager; "
          f"{c['graph_capture_s']:.2f} s capturing (inside the timed "
          f"run); shared pool "
          + ("not measured" if pool is None else f"{pool / 2**30:.3f} GiB")
          + f" [{ctx['card']}]")
    print(f"phase 4 capture cost: {capture_text(srv.graphs)} "
          f"[{ctx['card']}]")
    ctx["launches"] = launches
    ctx["serve4"] = {"specs": [(r.prompt, r.max_new_tokens) for r in reqs],
                     "results": run["results"],
                     "rate": gen_tokens / wall, "ttft": (p50, p99),
                     "capture_s": c["graph_capture_s"]}
    ctx["captured"] = probe_pass(ctx, srv, rng)
    del srv, model
    torch.cuda.empty_cache()


def capture_text(*caches) -> str:
    """The captures of ``caches`` (``GraphCache``s) and their seconds by
    part: ``torch.cuda.graph``'s entry synchronize, ``gc.collect()`` and
    allocator cache flushes, then the recording."""
    from collections import Counter

    parts, n = Counter(), 0
    for g in caches:
        parts.update(g.capture_parts)
        n += sum(v for (_, what), v in g.calls.items() if what == "captures")
    total = sum(g.capture_seconds for g in caches)
    return (f"{n} captures in {total:.3f} s: synchronize "
            f"{parts['sync']:.3f} s, gc.collect {parts['gc']:.3f} s, "
            f"empty_cache {parts['empty_cache']:.3f} s, recording "
            f"{parts['record']:.3f} s")


def device_busy(prof) -> tuple[float, int]:
    """(device microseconds, device ops) of a torch.profiler trace: the
    self device time summed over its events, and how many of them ran
    on the device (kernels, copies and fills)."""
    us = n = 0
    for r in prof.key_averages():
        t = getattr(r, "self_device_time_total",
                    getattr(r, "self_cuda_time_total", 0.0))
        if t > 0:
            us += t
            n += r.count
    return us, n


def pool_leaves(srv) -> list:
    """Every leaf of the Server's page pool."""
    import torch

    return [leaf for key, layer in srv.slots.cache.items()
            if key.startswith("block_") for leaf in layer.values()
            if isinstance(leaf, torch.Tensor)]


def probe_pass(ctx, srv, rng) -> dict:
    """A second, untimed pass on the same Server: 8 requests with
    1500-token prompts fill the batch. On the state after their first
    chunk (the pool saved and put back before each run): one chunk
    eagerly and one replayed must give the same tokens and pool bytes
    (4b); then three of each are timed, and the eager one keeps the
    largest flash-decode call for the kernel line. Then three steps are
    timed as they run and the next three run under torch.profiler
    (device activity only) for the device's busy time; the host share
    of wall is one less the busy time over the unprofiled steps' wall
    (the profiler slows the host several times over, so its own wall is
    not used)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import tony_tpu_torch.models.transformer as tmod
    from tony_tpu_torch.serve import Request
    from tony_tpu_torch.serve.engine import _decode_chunk

    captured = {}
    real = tmod.flash_decode

    def capture(q, k, v, length, **kw):
        if k.shape[1] > captured.get("S", 0):
            captured.update(S=k.shape[1], args=(
                q.clone(), k.clone(), v.clone(),
                torch.as_tensor(length).clone()), kw={
                    n: (x.clone() if torch.is_tensor(x) else x)
                    for n, x in kw.items()})
        return real(q, k, v, length, **kw)

    for i in range(8):
        srv.submit(Request(rng.integers(0, 151643, 1500).tolist(), 64,
                           id=f"probe{i}"))
    srv.step()  # admits all 8 and decodes one chunk
    check(srv.n_active == 8, f"probe pass: {srv.n_active} of 8 live")
    s = srv.slots
    k, cols, flat = srv._prepare_chunk()
    leaves = pool_leaves(srv)
    saved = [leaf.clone() for leaf in leaves]
    n = s.pool.n_pages

    def restore():
        for leaf, keep in zip(leaves, saved):
            leaf.copy_(keep)
        sync()

    def eager():
        return _decode_chunk(
            srv.model, s.cache, torch.as_tensor(flat, device=DEVICE),
            b=s.batch_size, cols=cols, n_steps=k,
            eos_ids=srv.eos_ids).cpu().numpy()

    if ("decode", k, cols) not in srv.graphs.entries:
        srv._run_chunk(flat, k, cols)  # its first call: eager, captured
        restore()
    tmod.flash_decode = capture
    try:
        want = eager()
    finally:
        tmod.flash_decode = real
    want_pool = [leaf[:n].clone() for leaf in leaves]
    restore()
    replays = srv.graphs.calls["decode", "replays"]
    got = srv._run_chunk(flat, k, cols)
    check(srv.graphs.calls["decode", "replays"] == replays + 1,
          "4b: the chunk was not a replay")
    check((got == want).all(), "4b: replayed chunk tokens differ from the "
          "eager chunk's")
    check(all(torch.equal(leaf[:n], w) for leaf, w in zip(leaves,
                                                           want_pool)),
          "4b: replayed chunk pool bytes differ from the eager chunk's")
    del want_pool
    print(f"phase 4b one chunk ({k} micro-steps, {cols} page columns, "
          f"batch 8) replayed and eager on one saved state: tokens and "
          f"pool bytes ({n} pages, junk page aside) bit-equal "
          f"[{ctx['card']}]")
    times = {"eager": [], "replayed": []}
    for _ in range(3):
        for name, run in (("eager", eager),
                          ("replayed", lambda: srv._run_chunk(flat, k,
                                                              cols))):
            restore()
            t0 = time.perf_counter()
            run()
            times[name].append(time.perf_counter() - t0)
    restore()
    chunk_ms = {name: statistics.median(t) * 1e3
                for name, t in times.items()}
    sync()
    w0 = time.perf_counter()
    for _ in range(3):
        srv.step()
    sync()
    wall = time.perf_counter() - w0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            srv.step()
        sync()
    check(srv.n_active == 8, f"probe pass: {srv.n_active} of 8 live "
          "after the profiled steps")
    while not srv.done:
        srv.step()
    del saved
    dev_us, ops = device_busy(prof)
    host = "not measured" if dev_us <= 0 else \
        f"{max(0.0, 1.0 - dev_us * 1e-6 / wall):.3f}"
    print(f"phase 4 probe (untimed pass, batch 8 at 1500-token prompts): "
          f"one chunk of {k} micro-steps on one state, median of 3: "
          f"eager {chunk_ms['eager']:.1f} ms, replayed "
          f"{chunk_ms['replayed']:.1f} ms; with replays, host share of "
          f"wall {host} (device busy {dev_us * 1e-3:.1f} ms in {ops} "
          f"device ops over 3 profiled steps; 3 unprofiled steps "
          f"{wall * 1e3:.1f} ms) [{ctx['card']}]")
    return captured


def write_checkpoint(config: dict | None = None) -> str:
    """A 2-layer checkpoint directory at the full width of ``config``
    (Qwen2.5-1.5B by default) under build/: config.json and
    model.safetensors, seeded random bf16 weights, with q/k/v biases for
    Qwen2 and an untied head where the config says so. The caller
    removes it."""
    import torch

    from tony_tpu_torch.models.hf import write_safetensors

    hf = dict(config or QWEN25_15B, num_hidden_layers=2)
    bias = hf["model_type"] == "qwen2"
    d, f, L, V = hf["hidden_size"], hf["intermediate_size"], 2, \
        hf["vocab_size"]
    kv = hf["num_key_value_heads"] * d // hf["num_attention_heads"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def w(*shape):
        return (0.02 * torch.randn(*shape, device=DEVICE,
                                   generator=gen)).bfloat16().cpu()

    tensors = {"model.embed_tokens.weight": w(V, d),
               "model.norm.weight": torch.ones(d, dtype=torch.bfloat16)}
    for i in range(L):
        p = f"model.layers.{i}."
        tensors[p + "input_layernorm.weight"] = torch.ones(
            d, dtype=torch.bfloat16)
        tensors[p + "post_attention_layernorm.weight"] = torch.ones(
            d, dtype=torch.bfloat16)
        for name, rows in (("q", d), ("k", kv), ("v", kv)):
            tensors[p + f"self_attn.{name}_proj.weight"] = w(rows, d)
            if bias:
                tensors[p + f"self_attn.{name}_proj.bias"] = w(rows)
        tensors.update({
            p + "self_attn.o_proj.weight": w(d, d),
            p + "mlp.gate_proj.weight": w(f, d),
            p + "mlp.up_proj.weight": w(f, d),
            p + "mlp.down_proj.weight": w(d, f)})
    if not hf["tie_word_embeddings"]:
        tensors["lm_head.weight"] = w(V, d)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="smoke_ckpt_",
                            dir=os.path.join(ROOT, "build"))
    with open(os.path.join(ckpt, "config.json"), "w") as fh:
        json.dump(hf, fh)
    write_safetensors(tensors, os.path.join(ckpt, "model.safetensors"))
    return ckpt


def serve_cli(ckpt: str, lines: list, *flags, err=None) -> dict:
    """``cli.generate --serve`` over ``ckpt`` with ``flags``, the JSONL
    ``lines`` piped in; its responses by id, each checked against its
    request: the prompt echoed, a finish reason and the budget kept.
    ``err``, a text stream, takes what the CLI writes to stderr."""
    from tony_tpu_torch.cli import generate as cli

    rfd, wfd = os.pipe()
    with os.fdopen(wfd, "w") as wf:
        wf.write("\n".join(json.dumps(x) for x in lines) + "\n")
    out = io.StringIO()
    saved = sys.stdin
    try:
        sys.stdin = os.fdopen(rfd)
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err or sys.stderr):
            rc = cli.main(["--model", ckpt, "--serve", "--flash-decode",
                           "--serve-batch", "4", "--kv-pages", "128",
                           "--device", DEVICE, *flags])
    finally:
        sys.stdin.close()
        sys.stdin = saved
    check(rc == 0, f"cli {flags}: exit code {rc}")
    got = {}
    for line in out.getvalue().strip().splitlines():
        doc = json.loads(line)
        got[doc["id"]] = doc
    check(set(got) == {x["id"] for x in lines},
          f"cli {flags} answered {sorted(got)}")
    for x in lines:
        doc = got[x["id"]]
        new = doc["token_ids"][len(x["token_ids"]):]
        check(doc["token_ids"][:len(x["token_ids"])] == x["token_ids"],
              f"{x['id']}: prompt not echoed")
        check(doc["finish_reason"] in ("eos", "length")
              and len(new) <= x["max_new_tokens"]
              and (doc["finish_reason"] == "eos"
                   or len(new) == x["max_new_tokens"]),
              f"{x['id']}: {doc['finish_reason']} with {len(new)} "
              f"of {x['max_new_tokens']} tokens")
    return got


def phase_cli(ctx) -> None:
    import numpy as np

    ckpt = write_checkpoint()
    try:
        rng = np.random.default_rng(SEED + 2)
        lines = [{"id": f"r{i}", "token_ids": rng.integers(
                     0, 151643, n).tolist(), "max_new_tokens": m}
                 for i, (n, m) in enumerate(((40, 12), (300, 20), (5, 1),
                                             (900, 8)))]
        got = serve_cli(ckpt, lines, "--dtype", "bf16")
        print(f"phase 5 cli --serve over a 2-layer full-width checkpoint: "
              f"{len(got)} of {len(lines)} JSONL responses checked")
        # speculation leaves greedy outputs as they are; in fp32, where
        # the window pass and the single step round alike, the responses
        # must be equal. Two more lines repeat a short pattern, prompt
        # lookup's best case
        lines += [{"id": f"p{i}", "token_ids": np.resize(rng.integers(
                      0, 151643, 7), n).tolist(), "max_new_tokens": 24}
                  for i, n in enumerate((64, 200))]
        plain = serve_cli(ckpt, lines, "--dtype", "fp32")
        spec = serve_cli(ckpt, lines, "--dtype", "fp32", "--speculate-k", "4")
        check(spec == plain, "cli --speculate-k 4: responses differ from "
              "the run without it: " + ", ".join(
                  k for k in plain if spec[k] != plain[k]))
        print(f"phase 5 cli --serve --speculate-k 4 (fp32): {len(spec)} "
              f"responses equal to the run without the flag")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def kernel_line(ctx) -> dict:
    """The main path's largest flash-decode call, replayed: error
    against the plain version and the times beside the bound, then the
    kernel's time at the split counts around the wrapper's."""
    import torch

    cap = ctx["captured"]
    q, k, v, length = cap["args"]
    kw = cap["kw"]
    args = (q, k, v, length, kw.get("window", 0), kw.get("k_scale"),
            kw.get("v_scale"), ctx["flush"])
    m = measure_decode(*args)
    print(f"flash_decode at the serve path's largest call (B={q.shape[0]}"
          f" H={q.shape[1]} KVH={k.shape[2]} D={q.shape[2]} S={k.shape[1]}"
          f" {k.dtype}; {m['route']}, {m['nsplit']} split(s)): max abs err "
          f"{m['max_abs_err']:.3g} (worst excess "
          f"{m['excess']:.3g} over {m['rtol']:.3g}*|want|, limit "
          f"{m['atol']:.3g}); kernel {m['ms'] * 1e3:.1f} us "
          f"({m['bound_ms'] / m['ms']:.3f} of the bound), plain "
          f"{m['plain_ms'] * 1e3:.1f} us, sdpa {m['library_ms'] * 1e3:.1f} "
          f"us, bound {m['bound_ms'] * 1e3:.2f} us [{ctx['card']}]")
    # the split rule against its neighbours: one, two and three blocks an
    # SM, and the rule's own count
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    groups = q.shape[0] * k.shape[2]
    splits = sorted({m["nsplit"]} | {max(1, -(-n * sms // groups))
                                     for n in (1, 2, 3)})
    by = decode_by_split(*args, splits)
    print("flash_decode at that call by KV splits (kernel only, C entry "
          "point): " + ", ".join(f"{n}: {t * 1e3:.1f} us"
                                 for n, t in by.items())
          + f" (the wrapper takes {m['nsplit']}) [{ctx['card']}]")
    return {"name": "flash_decode", "route": "cuda",
            "source": "tony_tpu_torch/csrc/flash_decode.cu",
            "replaces": "tony_tpu/ops/decode.py:70",
            "launches": ctx["launches"], "max_abs_err": m["max_abs_err"],
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"]}


# ------------------------------------------------------------ training

PEAK_BF16 = PEAK_OPS["bfloat16"]
TRAIN_SEQ, TRAIN_MICRO, TRAIN_ACCUM, TRAIN_STEPS = 2048, 4, 2, 8
TRAIN_LR, TRAIN_WARMUP = 3e-4, 4


def attention_bound(q, k, vis_pairs: int, products: int,
                    nbytes: int) -> tuple[float, str]:
    """Least time for a flash-attention kernel on these inputs: 2 * D
    flops per visible (query, key) pair of each q head for each of its
    ``products`` matrix products, at the peak rate for the inputs' type,
    against ``nbytes`` over HBM bandwidth."""
    d = q.shape[3]
    ops = vis_pairs * 2 * d * products
    t_ops = ops / PEAK_OPS[str(q.dtype).split(".")[-1]] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def packed_segments(b: int, l: int):
    """Three packed documents a row, at a quarter and just past half."""
    import torch

    cuts = torch.tensor([l // 4, l // 2 + 3], device=DEVICE)
    return (torch.arange(l, device=DEVICE)[None, :, None]
            >= cuts[None, None, :]).sum(-1).to(torch.int32) \
        .expand(b, l).contiguous()


def measure_attention(b, l, h, kvh, d, dtype, window, segments, flush,
                      timed: bool) -> dict:
    """The three kernels against their plain versions on one input set:
    every output held to ``error_bound`` and inputs left unchanged, then
    (``timed``) the times."""
    import torch
    import torch.nn.functional as F

    from tony_tpu_torch.ops import attention as att

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + l + h + d)
    q, k, v, do = (torch.randn(b, l, n, d, device=DEVICE, generator=gen)
                   .to(dtype) for n in (h, kvh, kvh, h))
    seg = packed_segments(b, l) if segments else None
    kw = dict(causal=True, window=window, segment_ids=seg)
    inputs = [q, k, v, do] + ([seg] if seg is not None else [])
    before = [t.clone() for t in inputs]
    o, lse = att.flash_attention_fwd(q, k, v, **kw)
    dq = att.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)
    dk, dv = att.flash_attention_bwd_dkv(q, k, v, o, lse, do, **kw)
    sync()
    check(all(torch.equal(a, c) for a, c in zip(inputs, before)),
          "a flash attention kernel wrote into its inputs")
    with torch.no_grad():
        o_ref, lse_ref = att.flash_attention_reference(
            q, k, v, True, window, seg, return_lse=True)
        lim = att.error_bound(q, k, v, o_ref, lse_ref, **kw)
        worst = {}

        def hold(name, got, want, limit):
            diff = (got.float() - want.float()).abs()
            check(bool(torch.isfinite(got.float()).all()),
                  f"{name} not finite")
            excess = (diff - limit).max().item()
            check(excess <= 0, f"{name}: |got - want| exceeds its limit by "
                  f"{excess:.3g} (max abs err {diff.max().item():.3g})")
            worst[name] = (diff.max().item(), (diff / limit).max().item(),
                           want.float().abs().max().item())

        hold("o", o, o_ref, lim["o"])
        hold("lse", lse, lse_ref, 1e-5 * (1 + lse_ref.abs()))
        del o_ref, lim
        grads = att.flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
        lim = att.error_bound(q, k, v, o, lse, do, **kw)
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), grads):
            hold(name, got, want, lim[name])
        del grads, lim
        vis = att.visibility(l, l, True, window, seg, DEVICE)
        pairs = int(vis.sum()) * (b if seg is None else 1) * h
        del vis
    out = {"err": worst, "pairs": pairs}
    if dtype == torch.bfloat16:
        # the tensor-core kernels sum in a fixed order: a second run
        # gives the same bits
        o2, lse2 = att.flash_attention_fwd(q, k, v, **kw)
        dq2 = att.flash_attention_bwd_dq(q, k, v, o, lse, do, **kw)
        dk2, dv2 = att.flash_attention_bwd_dkv(q, k, v, o, lse, do, **kw)
        sync()
        check(torch.equal(o, o2) and torch.equal(lse, lse2),
              "a second run of the bf16 forward kernel differs")
        check(torch.equal(dq, dq2) and torch.equal(dk, dk2)
              and torch.equal(dv, dv2),
              "a second run of the bf16 backward kernels differs")
        out["bit_equal"] = True
        del o2, lse2, dq2, dk2, dv2
    if not timed:
        return out
    es = q.element_size()
    qkv = (q.numel() + k.numel() + v.numel()) * es
    rows = b * h * l * 4
    segb = seg.numel() * 4 if seg is not None else 0
    # the backward's calls as FlashAttention.backward makes them: delta
    # once, in PyTorch, then both kernels
    delta = att._delta(o, do)
    fwd = lambda: att.flash_attention_fwd(q, k, v, **kw)  # noqa: E731
    bdq = lambda: att.flash_attention_bwd_dq(q, k, v, o, lse, do,  # noqa: E731,E501
                                             delta=delta, **kw)
    bdkv = lambda: att.flash_attention_bwd_dkv(q, k, v, o, lse, do,  # noqa: E731,E501
                                               delta=delta, **kw)

    def plain_fwd():
        with torch.no_grad():
            att.flash_attention_reference(q, k, v, True, window, seg,
                                          return_lse=True)

    def plain_bwd():
        with torch.no_grad():
            att.flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)

    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=kvh != h)
    dot = do.transpose(1, 2)

    def lib_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=kvh != h)

    def lib_bwd():
        torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)

    reps = 5
    group = h // kvh
    if dtype == torch.bfloat16 and group > 1:
        # dK/dV at every split of the query group (the wrapper's rule
        # picks the fewest that fill the card's block slots)
        dkv_out = torch.empty_like(k), torch.empty_like(v)
        out["splits"] = {}
        for s in (s for s in range(1, group + 1) if group % s == 0):
            part = torch.empty(2 * s * k.numel(), dtype=torch.float32,
                               device=DEVICE) if s > 1 else None
            out["splits"][s] = cuda_time_ms(
                lambda: att._launch(2, q, k, v, seg, causal=True,
                                    window=window, do=do, lse=lse,
                                    delta=delta, dk=dkv_out[0],
                                    dv=dkv_out[1], part=part, splits=s),
                reps, flush)
            del part
        out["split"] = att.dkv_splits(b, l, kvh, group, q.device)
        del dkv_out
    out.update(
        delta=cuda_time_ms(lambda: att._delta(o, do), reps, flush),
        fwd=cuda_time_ms(fwd, reps, flush),
        dq=cuda_time_ms(bdq, reps, flush),
        dkv=cuda_time_ms(bdkv, reps, flush),
        plain_fwd=cuda_time_ms(plain_fwd, 3, flush),
        plain_bwd=cuda_time_ms(plain_bwd, 3, flush),
        lib_fwd=cuda_time_ms(lib_fwd, reps, flush),
        lib_bwd=cuda_time_ms(lib_bwd, reps, flush),
        bound_fwd=attention_bound(q, k, pairs, 2, qkv + q.numel() * es
                                  + rows + segb),
        bound_dq=attention_bound(q, k, pairs, 3, qkv + 2 * q.numel() * es
                                 + 2 * rows + segb),
        bound_dkv=attention_bound(q, k, pairs, 4, qkv + q.numel() * es
                                  + (k.numel() + v.numel()) * es
                                  + 2 * rows + segb))
    return out


def measure_logit_route(ctx) -> None:
    """Which route chunked cross-entropy's bf16 logit products take here,
    and what the fp32 upcast would cost instead, on one vocab tile of the
    training path ([4 x 2047, 1536] x [1536, 2048])."""
    import torch

    from tony_tpu_torch.ops.xent import logit_route

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    h = torch.randn(TRAIN_MICRO * (TRAIN_SEQ - 1),
                    QWEN25_15B["hidden_size"], device=DEVICE,
                    generator=gen).bfloat16()
    e = torch.randn(2048, QWEN25_15B["hidden_size"], device=DEVICE,
                    generator=gen).bfloat16()
    route = logit_route(DEVICE)
    upcast = cuda_time_ms(lambda: h.float() @ e.float().t(), 5, ctx["flush"])
    line = f"phase 6 chunked CE logit route: {route}; one tile by the fp32 " \
        f"upcast {upcast:.3f} ms"
    if route == "mm_out_dtype":
        mm = cuda_time_ms(lambda: torch.mm(h, e.t(), out_dtype=torch.float32),
                          5, ctx["flush"])
        want = h.float() @ e.float().t()
        got = torch.mm(h, e.t(), out_dtype=torch.float32)
        err = ((got - want).abs().max() / want.abs().max()).item()
        line += f", by bf16 operands with an fp32 output {mm:.3f} ms " \
            f"(max difference {err:.3g} of the largest logit)"
    print(line + f" [{ctx['card']}]")


def qwen_param_shapes() -> dict:
    import torch

    from tony_tpu_torch.models.transformer import Transformer

    meta = Transformer(qwen_config(dtype=torch.float32), device="meta")
    return {n: tuple(t.shape) for n, t in meta.state_dict().items()}


def train_grad_dtype():
    """The grads' dtype that phase 8's step hands fused AdamW:
    ``Trainer`` returns its fp32 accumulators when ``accum_steps`` > 1,
    else the module's bf16 grads. Phase 8 checks it."""
    import torch

    return torch.float32 if TRAIN_ACCUM > 1 else torch.bfloat16


def measure_adamw(flush) -> dict:
    """Fused AdamW over every leaf of Qwen2.5-1.5B (grads of phase 8's
    dtype, fp32 master and moments, bf16 copy: the group the training
    path launches): one step against the plain version, held to one fp32
    step (one bf16 step for the copy), inputs unchanged; then the times."""
    import torch

    from tony_tpu_torch.ops import adamw as adw

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    shapes = qwen_param_shapes()
    opt = adw.FusedAdamW(3e-4)
    gdt = train_grad_dtype()
    params = {n: 0.02 * torch.randn(*s, device=DEVICE, generator=gen)
              for n, s in shapes.items()}
    grads = {n: (1e-3 * torch.randn(*s, device=DEVICE, generator=gen))
             .to(gdt) for n, s in shapes.items()}
    state = opt.init(params, compute_dtype=torch.bfloat16)
    # one step first, so the moments are not zero (the count advances
    # in place)
    adw.fused_adamw_update(opt, grads, state, params)
    ref_p = {n: t.clone() for n, t in params.items()}
    ref_s = adw.FusedAdamWState(
        count=state.count.clone(),
        mu={n: t.clone() for n, t in state.mu.items()},
        nu={n: t.clone() for n, t in state.nu.items()},
        compute_params={n: t.clone()
                        for n, t in state.compute_params.items()})
    g_before = {n: t.clone() for n, t in grads.items()}
    params, state = adw.fused_adamw_update(opt, grads, state, params)
    lr, c1, c2 = adw._hyper(opt, ref_s.count)
    for n in shapes:
        adw.leaf_update_reference(
            grads[n], ref_p[n], ref_s.mu[n], ref_s.nu[n], lr, c1, c2,
            b1=opt.b1, b2=opt.b2, eps=opt.eps, wd=opt.weight_decay,
            copy=ref_s.compute_params[n])
    sync()
    check(all(torch.equal(grads[n], g_before[n]) for n in shapes),
          "fused AdamW wrote into its grads")
    del g_before
    err, bit_equal = 0.0, True
    for n in shapes:
        for got, want, step in (
                (params[n], ref_p[n], 2.0 ** -23),
                (state.mu[n], ref_s.mu[n], 2.0 ** -23),
                (state.nu[n], ref_s.nu[n], 2.0 ** -23),
                (state.compute_params[n], ref_s.compute_params[n],
                 2.0 ** -8)):
            diff = (got.float() - want.float()).abs()
            excess = (diff - step * want.float().abs()).max().item()
            check(excess <= 0, f"fused AdamW {n}: exceeds one step by "
                  f"{excess:.3g}")
            err = max(err, diff.max().item())
            bit_equal = bit_equal and torch.equal(got, want)
    check(bit_equal, "fused AdamW is not bit-equal to its plain version")
    n_el = sum(t.numel() for t in params.values())
    # read g, p, mu, nu; write p, mu, nu and the bf16 copy
    nbytes = n_el * (gdt.itemsize + 3 * 4 + 3 * 4 + 2)
    ops = n_el * 15
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS["float32"] * 1e3

    def kernel():
        adw.fused_adamw_update(opt, grads, state, params)

    def plain():
        for n in shapes:
            adw.leaf_update_reference(
                grads[n], ref_p[n], ref_s.mu[n], ref_s.nu[n], lr, c1, c2,
                b1=opt.b1, b2=opt.b2, eps=opt.eps, wd=opt.weight_decay,
                copy=ref_s.compute_params[n])

    def host_ms(reps: int, rebuild: bool) -> float:
        """The wrapper's host time a call, a sync on each side; with
        ``rebuild`` its table cache emptied first, so the call builds
        and uploads the table, as every call did before the cache."""
        host = []
        for _ in range(reps):
            if rebuild:
                adw._tables.clear()
            sync()
            t0 = time.perf_counter()
            kernel()
            host.append(time.perf_counter() - t0)
            sync()
        return statistics.median(host) * 1e3

    host = {"cached": host_ms(10, False), "built": host_ms(5, True)}
    plain_ms = cuda_time_ms(plain, 3, flush)
    del plain, ref_s
    # the yardstick: PyTorch's fused AdamW on the same params and grads
    # (fp32: its fused path needs grads of the params' dtype), no copy
    lib_params = list(ref_p.values())
    for n, t in zip(ref_p, lib_params):
        t.grad = grads[n].float()
    lib = torch.optim.AdamW(lib_params, lr=3e-4, weight_decay=1e-4,
                            fused=True)
    lib.step()
    # kernel and library in turn, three rounds: the spread between
    # rounds of one call says how far apart two readings may fall
    rounds = [(cuda_time_ms(kernel, 5, flush),
               cuda_time_ms(lib.step, 5, flush)) for _ in range(3)]
    del kernel, lib, lib_params, ref_p, params, state, grads
    return {"max_abs_err": err, "bit_equal": bit_equal,
            "ms": statistics.median(r[0] for r in rounds),
            "library_ms": statistics.median(r[1] for r in rounds),
            "rounds": rounds, "host_ms": host["cached"],
            "host_built_ms": host["built"], "plain_ms": plain_ms, "n": n_el,
            "nbytes": nbytes,
            "bound": (t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")}


def phase_train_kernels(ctx) -> None:
    import torch

    flush = ctx["flush"]
    hf = QWEN25_15B
    b, l = TRAIN_MICRO, TRAIN_SEQ
    h, kvh = hf["num_attention_heads"], hf["num_key_value_heads"]
    d = hf["hidden_size"] // h
    cases = [  # name, b, l, h, kvh, d, dtype, window, segments, timed
        ("main", b, l, h, kvh, d, torch.bfloat16, 0, False, True),
        ("fp32", b, l // 2, h, kvh, d, torch.float32, 0, False, False),
        ("window512", b, l, h, kvh, d, torch.bfloat16, 512, False, False),
        ("segments3", b, l, h, kvh, d, torch.bfloat16, 0, True, False),
        (f"L{l - 1}", b, l - 1, h, kvh, d, torch.bfloat16, 0, False,
         False),
        ("mha-d64", b, l, 16, 16, 64, torch.bfloat16, 0, False, False),
    ]
    for name, *shape, timed in cases:
        m = measure_attention(*shape, flush, timed)
        bb, ll, hh, kk, dd, dt, win, segs = shape
        errs = "; ".join(f"{k} {e:.3g} ({r:.3f} of its limit, max|want| "
                         f"{w:.3g})" for k, (e, r, w) in m["err"].items())
        bits = "; bf16 o/lse/dq/dk/dv bit-equal on a second run" \
            if m.get("bit_equal") else ""
        print(f"phase 6 flash attention {name}: B={bb} L={ll} H={hh} "
              f"KVH={kk} D={dd} {str(dt).split('.')[-1]} window={win} "
              f"segments={'3' if segs else 'none'}: max abs err {errs}"
              f"{bits}")
        if timed:
            ctx["attention"] = m
            for kern, plain, lib, bound, products in (
                    ("fwd", "plain_fwd", "lib_fwd", "bound_fwd", 2),
                    ("dq", "plain_bwd", "lib_bwd", "bound_dq", 3),
                    ("dkv", "plain_bwd", "lib_bwd", "bound_dkv", 4)):
                tflops = m["pairs"] * 2 * dd * products / m[kern] / 1e9
                print(f"  {kern}: kernel {m[kern]:.3f} ms ({tflops:.1f} "
                      f"TFLOP/s, {m[bound][0] / m[kern]:.3f} of the bound)"
                      f", plain {m[plain]:.3f} ms, sdpa {m[lib]:.3f} ms, "
                      f"bound {m[bound][0]:.4f} ms ({m[bound][1]}) "
                      f"[{ctx['card']}]")
            if "splits" in m:
                print("  dkv by split of the query group: " + ", ".join(
                    f"{s}: {t:.3f} ms" for s, t in m["splits"].items())
                    + f" (the wrapper takes {m['split']}) [{ctx['card']}]")
            print(f"  delta = rowsum(dO * O) in PyTorch, once a backward: "
                  f"{m['delta']:.3f} ms")
            bwd = m["dq"] + m["dkv"]
            print(f"  backward dq + dkv: {bwd:.3f} ms "
                  f"({m['pairs'] * 2 * dd * 7 / bwd / 1e9:.1f} TFLOP/s "
                  f"over the 7 products the two kernels run, "
                  f"{m['pairs'] * 2 * dd * 5 / bwd / 1e9:.1f} over the "
                  f"backward's 5; "
                  f"{(m['bound_dq'][0] + m['bound_dkv'][0]) / bwd:.3f} of "
                  f"the bounds' sum), with delta {bwd + m['delta']:.3f} ms; "
                  f"sdpa backward {m['lib_bwd']:.3f} ms "
                  f"({(bwd + m['delta']) / m['lib_bwd']:.2f}x) "
                  f"[{ctx['card']}]")
        torch.cuda.empty_cache()
    measure_logit_route(ctx)
    a = measure_adamw(flush)
    ctx["adamw"] = a
    gdt = str(train_grad_dtype()).split(".")[-1]
    print(f"phase 6 fused AdamW over the Qwen2.5-1.5B leaf set ({a['n']} "
          f"params, {gdt} grads as phase 8 gives them, fp32 master and "
          f"moments, bf16 copy): max "
          f"abs err {a['max_abs_err']:.3g}, bit-equal to the plain version "
          f"{a['bit_equal']}; kernel {a['ms']:.3f} ms, plain "
          f"{a['plain_ms']:.3f} ms, torch AdamW(fused) {a['library_ms']:.3f}"
          f" ms, bound {a['bound'][0]:.3f} ms ({a['bound'][1]}, "
          f"{a['nbytes'] / 1e9:.1f} GB), {a['nbytes'] / a['ms'] / 1e9:.3f} "
          f"TB/s ({a['bound'][0] / a['ms']:.3f} of the bound); the "
          f"wrapper's host time {a['host_ms']:.3f} ms a call, "
          f"{a['host_built_ms']:.3f} ms when it builds its table "
          f"[{ctx['card']}]")
    print("  kernel / AdamW(fused) by round (medians of 5 calls): "
          + ", ".join(f"{k:.3f} / {lib:.3f} ms" for k, lib in a["rounds"]))
    torch.cuda.empty_cache()


def phase_grad_check(ctx) -> None:
    import torch

    import tony_tpu_torch.models.transformer as tmod
    from tony_tpu_torch.models.transformer import Transformer
    from tony_tpu_torch.ops.attention import flash_attention_reference
    from tony_tpu_torch.ops.xent import chunked_cross_entropy

    cfg = qwen_config(dtype=torch.float32, attention_backend="pallas")
    model = Transformer(cfg, device=DEVICE).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    toks = torch.randint(0, cfg.vocab_size, (1, TRAIN_SEQ), device=DEVICE,
                         generator=gen)

    def loss_and_grads():
        for p in model.parameters():
            p.grad = None
        hidden = model(toks, return_hidden=True)
        loss = chunked_cross_entropy(hidden[:, :-1], model.embedding,
                                     toks[:, 1:], chunk_size=2048)
        loss.backward()
        sync()
        grads = {n: p.grad for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        return loss.detach(), grads

    loss_k, grads_k = loss_and_grads()
    kernel_attention = tmod.flash_attention

    def plain_attention(q, k, v, causal=True, block_q=0, block_k=0,
                        window=0, segment_ids=None):
        return flash_attention_reference(q, k, v, causal, window,
                                         segment_ids)

    tmod.flash_attention = plain_attention
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        tmod.flash_attention = kernel_attention
    check(bool(torch.isfinite(loss_k)), "kernel-route loss not finite")
    dl = abs(float(loss_k) - float(loss_p))
    check(dl <= 1e-5 * abs(float(loss_p)),
          f"losses differ: kernels {float(loss_k)}, plain {float(loss_p)}")
    worst, worst_name = 0.0, ""
    for n, gp in grads_p.items():
        gk = grads_k[n]
        check(bool(torch.isfinite(gk).all()), f"grad {n} not finite")
        ratio = ((gk - gp).abs().max() / gp.abs().max().clamp_min(1e-30)
                 ).item()
        if ratio > worst:
            worst, worst_name = ratio, n
    check(worst <= 1e-3, f"grad {worst_name}: max|kernel - plain| is "
          f"{worst:.3g} of max|plain| > 1e-3")
    print(f"phase 7 Qwen2.5-1.5B fp32 {cfg.n_layers} layers, 1 x "
          f"{TRAIN_SEQ} tokens, chunked CE: loss {float(loss_k):.6f} "
          f"(kernels) vs {float(loss_p):.6f} (plain), |diff| {dl:.3g} "
          f"(limit 1e-5 relative); gradients over {len(grads_p)} leaves: "
          f"worst max|kernel - plain| / max|plain| {worst:.3g} at "
          f"{worst_name} (limit 1e-3)")
    del model, grads_k, grads_p
    torch.cuda.empty_cache()


def train_flops_per_token(cfg, n_params: int) -> float:
    """Model FLOPs per trained token: 6 N for the matrix products (the
    tied embedding counts once, as the LM head), plus the causal
    attention scores and values, 6 * n_layers * H * D * L (3 x the
    forward's 2 products of 2 * H * D flops over L / 2 keys)."""
    return 6.0 * n_params + 6.0 * cfg.n_layers * cfg.n_heads \
        * cfg.head_dim * TRAIN_SEQ


def phase_fit(ctx) -> None:
    import numpy as np
    import torch

    import tony_tpu_torch.train.trainer as tr_mod
    from tony_tpu_torch.examples import lm_pretrain
    from tony_tpu_torch.ops import adamw, attention
    from tony_tpu_torch.train import fit

    # the recipe the job of phase 18 runs (tony_tpu_torch/examples/
    # lm_pretrain.py): 3e-4 after TRAIN_WARMUP steps, ramped linearly
    # before, a tensor of the device count, as a captured step needs
    cfg = qwen_config(dtype=torch.bfloat16, attention_backend="pallas",
                      remat=True, remat_policy="attn_saved")
    model, trainer, loader = lm_pretrain.build(
        cfg, seed=SEED, micro=TRAIN_MICRO, accum=TRAIN_ACCUM,
        seq_len=TRAIN_SEQ, lr=TRAIN_LR, warmup=TRAIN_WARMUP, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    gb = TRAIN_MICRO * TRAIN_ACCUM
    stamps = []

    def stamp(step, metrics):
        # step 1's metrics are read once step 2 is queued: wait for the
        # card there, so the timed window starts where step 2 ends
        if not stamps:
            sync()
        stamps.append((step, time.perf_counter()))

    # record the grads' dtypes the step hands fused AdamW, which phase 6
    # measured at
    grad_dtypes = set()
    update = tr_mod.fused_adamw_update

    def recording_update(opt, grads, *args, **kw):
        grad_dtypes.update(g.dtype for g in grads.values())
        return update(opt, grads, *args, **kw)

    torch.cuda.reset_peak_memory_stats()
    counters = (attention.flash_attention_fwd,
                attention.flash_attention_bwd_dq,
                attention.flash_attention_bwd_dkv, adamw.fused_adamw_update)
    for c in counters:
        c.launches = 0
    tr_mod.fused_adamw_update = recording_update
    try:
        sync()
        t0 = time.perf_counter()
        result = fit(trainer, None, loader, num_steps=TRAIN_STEPS,
                     log_every=1, metric_sinks=[stamp])
        sync()
        t_end = time.perf_counter()
        wall = t_end - t0
    finally:
        tr_mod.fused_adamw_update = update
    check(grad_dtypes == {train_grad_dtype()},
          f"the step gave fused AdamW {grad_dtypes} grads; phase 6 "
          f"measured {train_grad_dtype()}")
    launches = [c.launches for c in counters]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [hst["loss"] for hst in result.history if "loss" in hst]
    check(result.steps_run == TRAIN_STEPS and len(losses) == TRAIN_STEPS,
          f"fit ran {result.steps_run} steps, logged {len(losses)}")
    check(all(np.isfinite(losses)), f"losses not finite: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    per_fwd = cfg.n_layers * TRAIN_ACCUM * TRAIN_STEPS
    check(launches[:3] == [per_fwd] * 3,
          f"flash attention launches {launches[:3]}, expected {per_fwd} "
          f"each ({cfg.n_layers} layers x {TRAIN_ACCUM} micro-batches x "
          f"{TRAIN_STEPS} steps; attn_saved never reruns the forward)")
    check(launches[3] == TRAIN_STEPS,
          f"fused AdamW launches {launches[3]}, expected {TRAIN_STEPS} "
          "(one dtype group a step)")
    g = trainer.graphs
    calls = [g.calls["train_step", w] for w in ("captures", "replays",
                                                "eager")]
    check(calls == [1, TRAIN_STEPS - 1, 0],
          f"phase 8: train_step captures/replays/eager {calls}, expected "
          f"1/{TRAIN_STEPS - 1}/0 (one key: the first step eager then "
          "captured, every later step a replay)")
    # steady steps: from the end of step 2 on the card to the end of the
    # last, over their count. The host's metric reads alone would not do:
    # they track how far the host runs ahead, not when the card ends a step
    check(len(stamps) == TRAIN_STEPS, f"{len(stamps)} metric stamps")
    step_ms = (t_end - stamps[0][1]) / (TRAIN_STEPS - 2) * 1e3
    tokens = gb * TRAIN_SEQ
    flops = train_flops_per_token(cfg, n_params) * tokens
    tok_s = tokens / (step_ms / 1e3)
    mfu = flops / (step_ms / 1e3) / PEAK_BF16
    ctx["train_launches"] = launches
    pool = g.pool_bytes()
    print(f"phase 8 fit Qwen2.5-1.5B bf16 over fp32 masters, "
          f"{cfg.n_layers} layers, remat attn_saved, {TRAIN_MICRO} x "
          f"{TRAIN_ACCUM} x {TRAIN_SEQ} tokens a step, FusedAdamW(3e-4 "
          f"after a {TRAIN_WARMUP}-step warmup, a tensor of count), the "
          f"step captured whole: losses {[round(x, 4) for x in losses]}; "
          f"{step_ms:.1f} ms/step (steps 3-{TRAIN_STEPS}, replays, on the "
          f"card over their count; all {TRAIN_STEPS} in {wall:.1f} s), "
          f"{tok_s:.0f} tokens/s, MFU {mfu:.4f} ({n_params} params, 989 "
          f"TFLOP/s bf16 peak), peak memory {peak:.2f} GiB "
          f"(max_memory_allocated over fit: the first call, the capture "
          f"and the replays); launches fwd/dq/dkv/adamw {launches}, "
          f"replays included [{ctx['card']}]")
    print(f"phase 8 capture: {capture_text(g)}; graph pool "
          + ("not measured" if pool is None else f"{pool / 2**30:.2f} GiB")
          + f" [{ctx['card']}]")
    state, gate = train_replay_gate(ctx, trainer, result.state, loader,
                                    counters, cfg)
    per = {}
    for how, step_s in gate["step_s"].items():
        per[how] = {"ms": step_s * 1e3, "tok_s": tokens / step_s,
                    "mfu": flops / step_s / PEAK_BF16, **gate["probe"][how]}
    for how, r in per.items():
        print(f"phase 8 {how} step, on one saved state (3 steps timed "
              f"between syncs): {r['ms']:.1f} ms/step, {r['tok_s']:.0f} "
              f"tokens/s, MFU {r['mfu']:.4f}, host share {r['host']} "
              f"(device busy {r['busy_ms']:.1f} ms in a profiled step, "
              f"unprofiled step {r['wall_ms']:.1f} ms), peak memory "
              f"{gate['peak'][how]:.2f} GiB [{ctx['card']}]")
    prof = gate["prof"]
    dev_us = per["eager"]["busy_ms"] * 1e3
    host = per["eager"]["host"]
    top = sorted(prof.key_averages(),
                 key=lambda r: -getattr(r, "self_device_time_total",
                                        getattr(r, "self_cuda_time_total",
                                                0.0)))[:6]
    print("  the eager profiled step's largest device times:")
    for r in top:
        t = getattr(r, "self_device_time_total",
                    getattr(r, "self_cuda_time_total", 0.0))
        print(f"  device time {t * 1e-3:9.1f} ms  {r.key[:90]}")
    kernels = {"fwd": ("::fwd_kernel<", "::fwd_kernel_tc<"),
               "dq": ("::dq_kernel<", "::dq_kernel_tc<"),
               "dkv": ("::dkv_kernel<", "::dkv_kernel_tc<"),
               "dkv partial sums": ("::dkv_reduce(",)}
    attn = dict.fromkeys(kernels, 0.0)
    for r in prof.key_averages():
        for name, marks in kernels.items():
            if any(mark in r.key for mark in marks):
                attn[name] += getattr(r, "self_device_time_total",
                                      getattr(r, "self_cuda_time_total",
                                              0.0)) * 1e-3
    attn_ms = sum(attn.values())
    share = "not measured" if dev_us <= 0 else \
        f"{attn_ms / (dev_us * 1e-3):.3f}"
    print("  attention kernels' device time in the eager profiled step: "
          + ", ".join(f"{n} {t:.1f} ms" for n, t in attn.items())
          + f"; {attn_ms:.1f} ms, {share} of the device busy time")
    ctx["fit"] = {"step_ms": step_ms, "tok_s": tok_s, "mfu": mfu,
                  "peak_gib": peak, "losses": losses, "host": host,
                  "per": per}
    del result, state, trainer, model, prof, g
    torch.cuda.empty_cache()


def train_state_tensors(state) -> list:
    """Every tensor a training step writes: the masters, the count, the
    moments and the compute copies (the module's parameters)."""
    opt = state.opt_state
    return [*state.params.values(), opt.count, *opt.mu.values(),
            *opt.nu.values(), *(opt.compute_params or {}).values()]


def train_replay_gate(ctx, trainer, state, loader, counters, cfg):
    """Phase 8's gate: on one saved state (kept on the host), 3 steps
    replayed, then the state put back and the same 3 steps eager:
    losses and masters bit-equal, and every step raising the flash
    attention and AdamW launch counts by one step's launches. Each way
    also runs an untimed probe (one unprofiled step for its wall, one
    under torch.profiler for the device's busy time). The captured
    step's graph and its pool (about 23 GiB) are let go before the
    eager steps, which need that much room of their own. Returns the
    state and each way's seconds a step, peak memory and probe."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    it = loader.from_step(0)
    batches = [next(it) for _ in range(3)]
    it.close()
    live = train_state_tensors(state)
    saved = [t.to("cpu", copy=True) for t in live]
    per_step = [cfg.n_layers * TRAIN_ACCUM] * 3 + [1]
    out = {"loss": {}, "masters": {}, "step_s": {}, "peak": {},
           "probe": {}}
    graphs = trainer.graphs
    for how in ("replayed", "eager"):
        if how == "eager":
            graphs.entries.clear()
            torch.cuda.empty_cache()
            trainer.graphs = None
            for t, keep in zip(live, saved):
                t.copy_(keep)
        replays = graphs.calls["train_step", "replays"]
        torch.cuda.reset_peak_memory_stats()
        losses = []
        try:
            sync()
            t0 = time.perf_counter()
            for b in batches:
                before = [c.launches for c in counters]
                state, m = trainer.step(state, b)
                losses.append(m["loss"])
                rise = [c.launches - n for c, n in zip(counters, before)]
                check(rise == per_step, f"phase 8 {how} step: launches "
                      f"fwd/dq/dkv/adamw rose by {rise}, one step is "
                      f"{per_step}")
            sync()
            out["step_s"][how] = (time.perf_counter() - t0) / len(batches)
            out["peak"][how] = torch.cuda.max_memory_allocated() / 2 ** 30
            if how == "replayed":
                check(graphs.calls["train_step", "replays"] == replays + 3,
                      "phase 8: the gate's replayed steps were not replays")
            out["loss"][how] = torch.stack(losses).cpu()
            out["masters"][how] = [t.to("cpu", copy=True)
                                   for t in state.params.values()]
            w0 = time.perf_counter()
            state, _ = trainer.step(state, batches[0])
            sync()
            wall = time.perf_counter() - w0
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                state, _ = trainer.step(state, batches[0])
                sync()
        finally:
            trainer.graphs = graphs
        dev_us = sum(getattr(r, "self_device_time_total",
                             getattr(r, "self_cuda_time_total", 0.0))
                     for r in prof.key_averages())
        out["probe"][how] = {
            "host": "not measured" if dev_us <= 0 else
            f"{max(0.0, 1.0 - dev_us * 1e-6 / wall):.3f}",
            "busy_ms": dev_us * 1e-3, "wall_ms": wall * 1e3}
        out["prof"] = prof
    check(torch.equal(out["loss"]["replayed"], out["loss"]["eager"]),
          f"phase 8: replayed losses {out['loss']['replayed'].tolist()} "
          f"against eager {out['loss']['eager'].tolist()}")
    differ = [n for n, a, b in zip(state.params, out["masters"]["replayed"],
                                   out["masters"]["eager"])
              if not torch.equal(a, b)]
    check(not differ, f"phase 8: masters differ replayed against eager: "
          f"{differ[:4]} ({len(differ)} leaves)")
    print(f"phase 8 gate: 3 steps replayed and 3 eager from one saved "
          f"state: losses {out['loss']['eager'].tolist()} and all "
          f"{len(state.params)} masters bit-equal; each step raised "
          f"fwd/dq/dkv/adamw launches by {per_step} [{ctx['card']}]")
    return state, out


def train_kernel_lines(ctx) -> list[dict]:
    a, w = ctx["attention"], ctx["adamw"]
    launches = ctx["train_launches"]
    src = "tony_tpu_torch/csrc/flash_attention.cu"
    lines = []
    for i, (name, kern, plain, lib, bound, errs, site) in enumerate((
            ("flash_attention_fwd", "fwd", "plain_fwd", "lib_fwd",
             "bound_fwd", ("o", "lse"), "tony_tpu/ops/attention.py:140"),
            ("flash_attention_bwd_dq", "dq", "plain_bwd", "lib_bwd",
             "bound_dq", ("dq",), "tony_tpu/ops/attention.py:204"),
            ("flash_attention_bwd_dkv", "dkv", "plain_bwd", "lib_bwd",
             "bound_dkv", ("dk", "dv"), "tony_tpu/ops/attention.py:262"))):
        lines.append({
            "name": name, "route": "cuda", "source": src, "replaces": site,
            "launches": launches[i],
            "max_abs_err": max(a["err"][e][0] for e in errs),
            "ms": a[kern], "plain_ms": a[plain], "bound_ms": a[bound][0],
            "bound_by": a[bound][1], "library_ms": a[lib]})
    lines.append({
        "name": "fused_adamw", "route": "cuda",
        "source": "tony_tpu_torch/csrc/adamw.cu",
        "replaces": "tony_tpu/ops/adamw.py:74", "launches": launches[3],
        "max_abs_err": w["max_abs_err"], "ms": w["ms"],
        "plain_ms": w["plain_ms"], "bound_ms": w["bound"][0],
        "bound_by": w["bound"][1], "library_ms": w["library_ms"]})
    return lines


# ------------------------------------------------------------------ int8

Q8_SHAPES = (  # Qwen2.5-1.5B's seven projections have four (k, n) shapes
    ("q/o", 1536, 1536), ("k/v", 1536, 256), ("wg/wi", 1536, 8960),
    ("wo", 8960, 1536))
INT8_BATCH, INT8_PROMPT, INT8_STEPS, INT8_NEW = 8, 512, 16, 128


def q8_bound(x, w_q, out_dtype) -> tuple[float, str]:
    """Least time for q8_matmul on these inputs: x, the int8 weights and
    the scales read once and the output written once, over HBM
    bandwidth, against 2 m k n flops at the fp32 peak outside the tensor
    cores for an fp32 x (its products must be fp32) or the bf16
    tensor-core peak for a bf16 x."""
    import torch

    m, k = x.shape
    n = w_q.shape[1]
    nbytes = x.numel() * x.element_size() + w_q.numel() + 4 * n \
        + m * n * torch.empty((), dtype=out_dtype).element_size()
    peak = PEAK_OPS["float32" if x.dtype == torch.float32 else "bfloat16"]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * k * n / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def q8_library(ctx, x, w_q, scale):
    """(call, label): one PyTorch call computing the same product, timed
    and never used by the port. ``torch._weight_int8pack_mm`` (int8
    weights [n, k], scales in x's dtype) where it runs on the card for
    x's dtype and k and n are multiples of 64 (its CPU build crashes on
    k = 1000), else ``F.linear`` on weights dequantized ahead of time in
    x's dtype."""
    import torch
    import torch.nn.functional as F

    from tony_tpu_torch.ops.quant import dequantize_q8

    routes = ctx.setdefault("q8_library_route", {})
    if x.dtype not in routes:
        probe = torch.ones(2, 64, dtype=x.dtype, device=DEVICE)
        try:  # is the int8 product built for this dtype on the card?
            torch._weight_int8pack_mm(
                probe, torch.ones(64, 64, dtype=torch.int8, device=DEVICE),
                torch.ones(64, dtype=x.dtype, device=DEVICE))
            sync()
            routes[x.dtype] = "_weight_int8pack_mm"
        except (RuntimeError, NotImplementedError):
            routes[x.dtype] = "F.linear(dequantized)"
    if routes[x.dtype] == "_weight_int8pack_mm" \
            and x.shape[1] % 64 == 0 and w_q.shape[1] % 64 == 0:
        wt, sc = w_q.t().contiguous(), scale.to(x.dtype)
        return (lambda: torch._weight_int8pack_mm(x, wt, sc),
                routes[x.dtype])
    wd = dequantize_q8(w_q, scale).to(x.dtype).t().contiguous()
    return (lambda: F.linear(x, wd)), "F.linear(dequantized)"


def measure_q8(ctx, x, w_q, scale, reps=10) -> dict:
    """q8_matmul against its plain version on one input set, held per
    element to ``ops.quant.error_bound`` with inputs unchanged, then the
    times beside the bound and the library call."""
    import torch

    from tony_tpu_torch.ops import quant

    before = [t.clone() for t in (x, w_q, scale)]
    got = quant.q8_matmul(x, w_q, scale)
    sync()
    check(all(torch.equal(a, b) for a, b in zip((x, w_q, scale), before)),
          "q8_matmul wrote into its inputs")
    del before
    want = quant.q8_matmul_reference(x, w_q, scale)
    limit = quant.error_bound(x, w_q, scale, want)
    check(torch.equal(quant.q8_matmul(x, w_q, scale), got),
          f"q8_matmul x{tuple(x.shape)} {x.dtype} w{tuple(w_q.shape)}: a "
          f"rerun gave other bits")
    diff = (got.float() - want.float()).abs()
    check(bool(torch.isfinite(got.float()).all()), "q8_matmul not finite")
    worst = (diff / limit.clamp_min(1e-30)).max().item()
    err = diff.max().item()
    check(worst <= 1.0, f"q8_matmul x{tuple(x.shape)} {x.dtype} "
          f"w{tuple(w_q.shape)}: |got - want| reaches {worst:.3g} of its "
          f"limit (max abs err {err:.3g})")
    del got, want, limit, diff
    lib, route = q8_library(ctx, x, w_q, scale)
    ms = cuda_time_ms(lambda: quant.q8_matmul(x, w_q, scale), reps,
                      ctx["flush"])
    plain_ms = cuda_time_ms(
        lambda: quant.q8_matmul_reference(x, w_q, scale), reps,
        ctx["flush"])
    library_ms = cuda_time_ms(lib, reps, ctx["flush"])
    parts = kernel_breakdown(lambda: quant.q8_matmul(x, w_q, scale), reps,
                             ctx["flush"], "q8_")
    bound_ms, bound_by = q8_bound(x, w_q, x.dtype)
    m, k = x.shape
    n = w_q.shape[1]
    p = quant.plan(m, n, k, x.dtype, quant._sms(x.device.index))
    check(quant.kernel_route(x.dtype, m) == p.route,
          f"q8_matmul m={m} {x.dtype}: the CUDA source routes "
          f"{quant.kernel_route(x.dtype, m)}, the plan {p.route}")
    # achieved: bytes (x, weights, scales, out) or flops over the time
    nbytes = x.numel() * x.element_size() + k * n + 4 * n \
        + m * n * x.element_size()
    rate = (f"{nbytes / ms / 1e9:.3f} TB/s" if bound_by == "bytes"
            else f"{2.0 * m * k * n / ms / 1e9:.1f} TFLOP/s")
    return {"max_abs_err": err, "of_limit": worst, "ms": ms,
            "route": ("decode", "tensor cores", "SIMT tile")[p.route],
            "grid": p.grid, "splits": p.splits, "rate": rate,
            "parts": parts,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": route, "bound_ms": bound_ms, "bound_by": bound_by}


def norm_limit(want):
    """Per element: 2^-7 |want| for a bf16 output (each side rounds once;
    fp32 values a few ulps apart that straddle a rounding point land one
    bf16 step apart, up to 2^-7 of the value), 2^-20 |want| + 1e-7 for
    fp32 (the mean of squares summed in another order, an rsqrt within
    2 ulp)."""
    import torch

    if want.dtype == torch.bfloat16:
        return 2.0 ** -7 * want.float().abs()
    return 2.0 ** -20 * want.abs() + 1e-7


NORM_CALLS = ((8, 1536), (8192, 1536), (4096, 4096), (4096, 8192))


def measure_norms(ctx, rows: int, d: int, dtype) -> dict:
    """rmsnorm and add_rmsnorm against their plain versions at [rows, d]
    (residual and output in ``dtype``, fp32 scale), inputs unchanged,
    ``summed`` bit-equal and a rerun bit-equal; then the times by events
    beside the profiler's kernel time, the bytes bound, ``F.rms_norm``
    and (rmsnorm) a ``copy_`` of the same bytes, with each call's
    plan."""
    import torch
    import torch.nn.functional as F

    from tony_tpu_torch.ops import fused

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + rows)
    x = torch.randn(rows, d, device=DEVICE, generator=gen).to(dtype)
    r = torch.randn(rows, d, device=DEVICE, generator=gen).to(dtype)
    scale = 1 + 0.1 * torch.randn(d, device=DEVICE, generator=gen)
    before = [t.clone() for t in (x, r, scale)]
    out = fused.rmsnorm(x, scale)
    normed, summed = fused.add_rmsnorm(x, r, scale)
    sync()
    check(all(torch.equal(a, b) for a, b in zip((x, r, scale), before)),
          "a norm kernel wrote into its inputs")
    del before
    check(torch.equal(fused.rmsnorm(x, scale), out),
          f"rmsnorm rows={rows} D={d} {dtype}: a rerun gave other bits")
    again_n, again_s = fused.add_rmsnorm(x, r, scale)
    check(torch.equal(again_n, normed) and torch.equal(again_s, summed),
          f"add_rmsnorm rows={rows} D={d} {dtype}: a rerun gave other bits")
    del again_n, again_s
    want = fused.rmsnorm_reference(x, scale)
    want_n, want_s = fused.add_rmsnorm_reference(x, r, scale)
    check(torch.equal(summed, want_s), "add_rmsnorm: summed not bit-equal")
    res = {}
    for name, got, w in (("rmsnorm", out, want),
                         ("add_rmsnorm", normed, want_n)):
        diff = (got.float() - w.float()).abs()
        worst = (diff / norm_limit(w).clamp_min(1e-30)).max().item()
        check(worst <= 1.0, f"{name} rows={rows} D={d} {dtype}: |got - "
              f"want| reaches {worst:.3g} of its limit")
        res[name] = {"max_abs_err": diff.max().item(), "of_limit": worst}
    del want, want_n, want_s, diff
    es = x.element_size()
    w_lib = scale.to(dtype)
    flush = ctx["flush"]
    sms = fused._sms(x.device.index)
    for name, kern, plain, lib, nbytes, r_dt in (
            ("rmsnorm", lambda: fused.rmsnorm(x, scale),
             lambda: fused.rmsnorm_reference(x, scale),
             lambda: F.rms_norm(x, (d,), w_lib, 1e-6),
             rows * d * 2 * es + 4 * d, None),
            ("add_rmsnorm", lambda: fused.add_rmsnorm(x, r, scale),
             lambda: fused.add_rmsnorm_reference(x, r, scale),
             lambda: F.rms_norm(x + r, (d,), w_lib, 1e-6),
             rows * d * 4 * es + 4 * d, dtype)):
        res[name].update(
            ms=cuda_time_ms(kern, 10, flush),
            plain_ms=cuda_time_ms(plain, 10, flush),
            library_ms=cuda_time_ms(lib, 10, flush),
            parts=kernel_breakdown(kern, 10, flush, "norm_"),
            plan=fused.plan(rows, d, dtype, r_dt, sms),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    # what this timing lets a plain copy of rmsnorm's bytes reach
    res["rmsnorm"]["copy_ms"] = cuda_time_ms(lambda: out.copy_(x), 10, flush)
    return res


def phase_int8_kernels(ctx) -> None:
    import torch

    from tony_tpu_torch.ops.quant import quantize_q8

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    rows = []
    for name, k, n in Q8_SHAPES + (("ragged", 1000, 300),):
        w_q, scale = quantize_q8(
            0.02 * torch.randn(k, n, device=DEVICE, generator=gen))
        for m in ((257,) if name == "ragged" else (1, 8, 4096)):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(m, k, device=DEVICE, generator=gen).to(dtype)
                r = measure_q8(ctx, x, w_q, scale, reps=5 if m > 8 else 10)
                rows.append({"proj": name, "m": m, "k": k, "n": n,
                             "dtype": str(dtype).split(".")[-1], **r})
                print(f"phase 9 q8_matmul {name} m={m} k={k} n={n} "
                      f"{rows[-1]['dtype']}: route {r['route']}, grid "
                      f"{r['grid']} ({r['splits']} K splits); max abs err "
                      f"{r['max_abs_err']:.3g} ({r['of_limit']:.3f} of its "
                      f"limit), rerun bit-equal; kernel "
                      f"{r['ms'] * 1e3:.1f} us = {r['rate']} "
                      f"({r['bound_ms'] / r['ms']:.3f} of the bound), plain "
                      f"{r['plain_ms'] * 1e3:.1f} us, {r['library']} "
                      f"{r['library_ms'] * 1e3:.1f} us, bound "
                      f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}) "
                      f"[{ctx['card']}]")
                parts = "; ".join(
                    f"{k_} {t:.1f} us x {c:.0f}"
                    for k_, (t, c) in r["parts"].items()) or "not measured"
                print(f"  device time by kernel (torch.profiler, a call): "
                      f"{parts}; events {r['ms'] * 1e3:.1f} us")
                del x
        del w_q, scale
    ctx["q8_rows"] = rows
    norms = {}
    for nrows, d in NORM_CALLS:
        for dtype in (torch.bfloat16, torch.float32):
            res = measure_norms(ctx, nrows, d, dtype)
            dt = str(dtype).split(".")[-1]
            norms[(nrows, d, dt)] = res
            for name, r in res.items():
                p = r["plan"]
                route = ("one pass", "two passes")[p.route]
                kern_us = sum(t for t, _ in r["parts"].values())
                prof = f"{kern_us:.1f} us" if r["parts"] else "not measured"
                copy = f", copy_ of its bytes {r['copy_ms'] * 1e3:.1f} us" \
                    if "copy_ms" in r else ""
                print(f"phase 9 {name} rows={nrows} D={d} {dt}: {route}, "
                      f"{p.row_warps} warp(s) a row x {p.lane_vectors} "
                      f"vectors a lane, {p.block_rows} row(s) a block, grid "
                      f"{p.grid}; max abs err {r['max_abs_err']:.3g} "
                      f"({r['of_limit']:.3f} of its limit), rerun "
                      f"bit-equal; kernel {r['ms'] * 1e3:.1f} us by events "
                      f"({r['bound_ms'] / r['ms']:.3f} of the bound), "
                      f"{prof} by torch.profiler; plain "
                      f"{r['plain_ms'] * 1e3:.1f} us, F.rms_norm "
                      f"{r['library_ms'] * 1e3:.1f} us{copy}, bound "
                      f"{r['bound_ms'] * 1e3:.2f} us (bytes) "
                      f"[{ctx['card']}]")
    ctx["norms"] = norms
    torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_q8_route():
    """The model's q8_matmul swapped for its plain version."""
    import tony_tpu_torch.models.transformer as tmod
    from tony_tpu_torch.ops.quant import q8_matmul_reference

    kernel = tmod.q8_matmul
    tmod.q8_matmul = q8_matmul_reference
    try:
        yield
    finally:
        tmod.q8_matmul = kernel


def row_ratio(got, want) -> float:
    """The worst row's max |got - want| over its max |want|."""
    g, w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    return ((g - w).abs().amax(-1) / w.abs().amax(-1)).max().item()


def row_check(name, got, want, rel) -> float:
    """Each row's max |got - want| within ``rel`` of its max |want|;
    returns the worst row's ratio."""
    import torch

    check(bool(torch.isfinite(got).all()), f"{name}: logits not finite")
    ratio = row_ratio(got, want)
    check(ratio <= rel, f"{name}: a row's max |kernel - plain| is "
          f"{ratio:.3g} of its max |plain| > {rel:.3g}")
    return ratio


def phase_int8_model(ctx) -> None:
    import torch

    from tony_tpu_torch.models.generate import init_cache, single_decode_step
    from tony_tpu_torch.models.quantize import quantize_for_serving
    from tony_tpu_torch.models.transformer import Transformer
    from tony_tpu_torch.ops import add_rmsnorm, q8_matmul, rmsnorm

    base = Transformer(qwen_config(dtype=torch.float32), device=DEVICE) \
        .init_weights(torch.Generator(device=DEVICE).manual_seed(SEED))
    q32 = quantize_for_serving(base)
    del base
    torch.cuda.empty_cache()
    q16 = Transformer(dataclasses.replace(q32.cfg, dtype=torch.bfloat16),
                      device=DEVICE)
    q16.load_state_dict(q32.state_dict())
    cfg = q32.cfg
    per_fwd = 7 * cfg.n_layers
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    prompt = torch.randint(0, cfg.vocab_size, (INT8_BATCH, INT8_PROMPT),
                           device=DEVICE, generator=gen)
    length = INT8_PROMPT + INT8_STEPS
    fed, ref32 = None, None
    for name, model in (("fp32", q32), ("bf16", q16)):
        # the plain route; its fp32 run picks the tokens both dtypes feed
        with torch.no_grad(), plain_q8_route():
            cache = init_cache(model, INT8_BATCH, length)
            plain = [model(prompt, decode=True, cache=cache)]
            tok = torch.argmax(plain[0][:, -1], -1)
            picked = []
            for i in range(INT8_STEPS):
                picked.append(tok)
                cache, last = single_decode_step(
                    model, cache, tok if fed is None else fed[i])
                plain.append(last)
                tok = torch.argmax(last, -1)
        fed = fed or picked
        del cache
        if ref32 is None:
            # fp32: reordered fp32 sums through 28 layers (the phase-7
            # rule)
            rel, ref32 = 1e-3, plain
        else:
            # bf16: the two routes round each projection's output to bf16
            # once, from fp32 sums in another order, so outputs land a
            # bf16 step apart here and there and the steps travel through
            # 28 layers. Such noise is bf16 rounding's own: allow twice
            # what bf16 activations alone move the plain route's logits
            # from its fp32 run on the same tokens
            noise = max(row_ratio(p16, p32) for p16, p32 in zip(plain, ref32))
            rel = 2 * noise
            del ref32
        q8_matmul.launches = 0
        cache = init_cache(model, INT8_BATCH, length)
        with torch.no_grad():
            got = model(prompt, decode=True, cache=cache)
        sync()
        check(q8_matmul.launches == per_fwd,
              f"prefill launched q8_matmul {q8_matmul.launches} times, "
              f"expected 7 x {cfg.n_layers}")
        check(got.shape == (INT8_BATCH, INT8_PROMPT, cfg.vocab_size),
              f"logits shape {tuple(got.shape)}")
        pre = row_check(f"int8 {name} prefill", got, plain[0], rel)
        del got
        worst = 0.0
        for i in range(INT8_STEPS):
            cache, last = single_decode_step(model, cache, fed[i])
            worst = max(worst, row_check(f"int8 {name} decode step {i}",
                                         last, plain[i + 1], rel))
        sync()
        check(q8_matmul.launches == per_fwd * (1 + INT8_STEPS),
              f"q8_matmul launched {q8_matmul.launches} times over "
              f"{1 + INT8_STEPS} forwards, expected 7 x {cfg.n_layers} each")
        note = "" if name == "fp32" else \
            f" = 2 x {noise:.3g}, bf16's own distance from fp32"
        print(f"phase 10 int8 Qwen2.5-1.5B {name} activations, "
              f"{cfg.n_layers} layers: prefill {INT8_BATCH} x {INT8_PROMPT} "
              f"worst row max|kernel - plain| / max|plain| {pre:.3g}, "
              f"{INT8_STEPS} teacher-forced decode steps {worst:.3g} "
              f"(limit {rel:.3g}{note}); q8_matmul launches "
              f"{q8_matmul.launches} = {per_fwd} x {1 + INT8_STEPS} forwards")
        del cache
        if name == "bf16":
            del plain
        torch.cuda.empty_cache()
    # the fused norms are public ops that no model path calls (nor does
    # the JAX model): drive them as a user would, on the model's own
    # embedded tokens with block 0's norm scale, and hold them against
    # the model's plain RMSNorm module
    toks = torch.randint(0, cfg.vocab_size, (16, INT8_PROMPT),
                         device=DEVICE, generator=gen)
    ln1 = q16.blocks[0].ln1
    x = q16.embedding[toks].to(torch.bfloat16)
    r = q16.embedding[toks.roll(1, dims=1)].to(torch.bfloat16)
    rmsnorm.launches = add_rmsnorm.launches = 0
    out = rmsnorm(x, ln1.scale, eps=cfg.norm_eps)
    normed, summed = add_rmsnorm(x, r, ln1.scale, eps=cfg.norm_eps)
    sync()
    ctx["norm_launches"] = (rmsnorm.launches, add_rmsnorm.launches)
    s = x.float() + r.float()
    with torch.no_grad():
        for nm, got, want in (("rmsnorm", out, ln1(x)),
                              ("add_rmsnorm", normed, ln1(s))):
            worst = ((got.float() - want.float()).abs()
                     / norm_limit(want).clamp_min(1e-30)).max().item()
            check(worst <= 1.0, f"{nm} on the model's embeddings: "
                  f"{worst:.3g} of its limit from the RMSNorm module")
    check(torch.equal(summed, s.to(torch.bfloat16)),
          "add_rmsnorm: summed not bit-equal")
    print(f"phase 10 fused norms on the int8 model's embedded tokens "
          f"({x.shape[0] * x.shape[1]} rows, bf16) with block 0's scale: "
          f"equal to its RMSNorm module within the limit; launches "
          f"rmsnorm {rmsnorm.launches}, add_rmsnorm {add_rmsnorm.launches}")
    del q32, x, r, out, normed, summed, s
    ctx["int8_model"] = q16
    torch.cuda.empty_cache()


def time_generate(ctx, model, prompt) -> dict:
    """Greedy ``generate`` of INT8_NEW tokens, replayed and eager, each
    timed on the host around synchronised ends, tokens equal; a prefill
    alone, timed the same way; then an untimed probe of each step, the
    replayed one (the captured step's graph) and the eager one: 8 steps
    unprofiled for their wall and 8 under torch.profiler for the
    device's busy time (the host share, as in phase 4)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tony_tpu_torch.models.generate import (_generate_eager, generate,
                                                init_cache,
                                                single_decode_step)

    generate(model, prompt[:, :16], max_new_tokens=2)  # captures the step
    runs = {}
    greedy = functools.partial(torch.argmax, dim=-1)
    for name, run in (("replayed", generate), ("eager", functools.partial(
            _generate_eager, pick=greedy, eos_ids=()))):
        sync()
        t0 = time.perf_counter()
        out = run(model, prompt, max_new_tokens=INT8_NEW)
        sync()
        runs[name] = (time.perf_counter() - t0, out)
        if run is generate:
            c = model.graphs.counters(("generate",))
            check(c["generate_captures"] == 1
                  and c["generate_replays"] == INT8_NEW - 1,
                  f"generate: {c} (every step after the warm-up's "
                  "first must be a replay)")
    out = runs["replayed"][1]
    check(out.shape == (INT8_BATCH, INT8_NEW), f"generate gave "
          f"{tuple(out.shape)}")
    check(bool(((out >= 0) & (out < model.cfg.vocab_size)).all()),
          "generated ids out of range")
    check(torch.equal(out, runs["eager"][1]),
          "replayed generate's tokens differ from eager generate's")
    cache = init_cache(model, INT8_BATCH)
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        model(prompt, decode=True, cache=cache)
    sync()
    prefill = time.perf_counter() - t0
    tok = out[:, 0]
    (entry,) = [e for key, e in model.graphs.entries.items()
                if key[0] == "generate"]
    steps = {"replayed": lambda: model.graphs.run(entry, None),
             "eager": lambda: single_decode_step(model, cache, tok)}
    res = {}
    tokens = INT8_BATCH * INT8_NEW
    for name, step in steps.items():
        sync()
        w0 = time.perf_counter()
        for _ in range(8):
            step()
        sync()
        probe_wall = time.perf_counter() - w0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                step()
            sync()
        dev_us, ops = device_busy(prof)
        host = "not measured" if dev_us <= 0 else \
            f"{max(0.0, 1.0 - dev_us * 1e-6 / probe_wall):.3f}"
        wall = runs[name][0]
        res[name] = {
            "wall": wall, "tok_s": tokens / wall, "prefill": prefill,
            "step_ms": (wall - prefill) / (INT8_NEW - 1) * 1e3,
            "decode_tok_s": INT8_BATCH * (INT8_NEW - 1) / (wall - prefill),
            "host": host, "busy_ms": dev_us * 1e-3 / 8, "ops": ops / 8,
            "probe_ms": probe_wall * 1e3 / 8}
    return res


def phase_int8_generate(ctx) -> None:
    import torch

    import tony_tpu_torch.models.transformer as tmod
    from tony_tpu_torch.models.generate import init_cache, single_decode_step
    from tony_tpu_torch.models.transformer import Transformer
    from tony_tpu_torch.ops.quant import q8_matmul

    q16 = ctx.pop("int8_model")
    cfg = q16.cfg
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    prompt = torch.randint(0, cfg.vocab_size, (INT8_BATCH, INT8_PROMPT),
                           device=DEVICE, generator=gen)
    res = {}
    q8_matmul.launches = 0
    q8_matmul.route_launches[:] = [0, 0, 0]
    res["int8"] = time_generate(ctx, q16, prompt)
    launches = q8_matmul.launches
    routes = list(q8_matmul.route_launches)
    # the timed run: warm-up (a 16-token prefill and a step), generate
    # replayed and eager (a prefill and INT8_NEW - 1 steps each), a
    # prefill, 16 probe steps each way; every step (m = batch) takes the
    # decode route, replayed or not, every prefill (bf16 x) the tensor
    # cores
    prefills, steps = 4, 1 + 2 * (INT8_NEW - 1) + 2 * 16
    per = 7 * cfg.n_layers
    check(launches == per * (prefills + steps) and routes == [
        per * steps, per * prefills, 0],
          f"q8_matmul launched {launches} times, by route {routes}; "
          f"expected 7 x {cfg.n_layers} x ({steps} decode + {prefills} "
          f"prefill forwards)")
    ctx["q8_launches"] = routes
    # the largest decode and prefill calls of the path (wg/wi at m =
    # batch and m = batch x prompt), captured from one more step and one
    # more prefill for the kernel line
    captured = {}
    real = tmod.q8_matmul

    def capture(x, w_q, scale):
        key = x.shape[0]
        if w_q.shape[1] > captured.get(key, (0,))[0]:
            captured[key] = (w_q.shape[1], (x.clone(), w_q, scale))
        return real(x, w_q, scale)

    tmod.q8_matmul = capture
    try:
        single_decode_step(q16, init_cache(q16, INT8_BATCH, 16), prompt[:, 0])
        with torch.no_grad():
            q16(prompt, decode=True, cache=init_cache(q16, INT8_BATCH))
    finally:
        tmod.q8_matmul = real
    ctx["q8_captured"] = {"decode": captured[INT8_BATCH][1],
                          "prefill": captured[INT8_BATCH * INT8_PROMPT][1]}
    del q16
    torch.cuda.empty_cache()
    bf16 = Transformer(qwen_config(dtype=torch.bfloat16), device=DEVICE) \
        .init_weights(torch.Generator(device=DEVICE).manual_seed(SEED))
    res["bf16"] = time_generate(ctx, bf16, prompt)
    del bf16
    torch.cuda.empty_cache()
    for name, runs in res.items():
        for how, r in runs.items():
            print(f"phase 11 generate Qwen2.5-1.5B {name} weights (bf16 "
                  f"activations), {cfg.n_layers} layers, batch "
                  f"{INT8_BATCH}, {INT8_PROMPT}-token prompts, {INT8_NEW} "
                  f"greedy tokens, steps {how}: {r['wall']:.3f} s = "
                  f"{r['tok_s']:.1f} tok/s; prefill "
                  f"{r['prefill'] * 1e3:.1f} ms, then {r['step_ms']:.2f} "
                  f"ms a decode step = {r['decode_tok_s']:.1f} decode "
                  f"tok/s; host share {r['host']} (device busy "
                  f"{r['busy_ms']:.2f} ms in {r['ops']:.0f} device ops a "
                  f"step under the profiler, "
                  f"{r['probe_ms']:.2f} ms a step unprofiled) "
                  f"[{ctx['card']}]")
        print(f"phase 11 {name}: replayed tokens equal eager tokens")
    print(f"phase 11 q8_matmul launches in the int8 run: {launches} = 7 x "
          f"{cfg.n_layers} x ({steps} decode steps on the decode route, "
          f"replays counted from their captures + {prefills} prefills on "
          f"the tensor cores)")
    ctx["int8_generate"] = res


def phase_int8_cli(ctx) -> None:
    import numpy as np

    from tony_tpu_torch.cli import generate as cli
    from tony_tpu_torch.cli import score
    from tony_tpu_torch.ops.quant import q8_matmul

    def run(main, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(argv + ["--device", DEVICE])
        return rc, out.getvalue().strip().splitlines()

    def total_nll(lines):
        fields = dict(f.split("=") for f in lines[-1].split()[1:])
        check(lines[-1].startswith("TOTAL"), f"score printed {lines[-1]!r}")
        return float(fields["nll/token"])

    ckpt = write_checkpoint()
    try:
        rng = np.random.default_rng(SEED + 12)
        # below the end-of-text id 151643 (the rehearsal's vocabulary may
        # be smaller)
        top = min(151643, QWEN25_15B["vocab_size"])
        prompts = [rng.integers(0, top, n).tolist()
                   for n in (40, 40, 40, 300)]
        ids = [a for p in prompts for a in ("--token-ids",
                                            ",".join(map(str, p)))]
        q8_matmul.launches = 0
        rc, lines = run(cli.main, ["--model", ckpt, *ids, "--int8",
                                   "--max-new-tokens", "8"])
        check(rc == 0 and len(lines) == len(prompts),
              f"generate --int8: exit {rc}, {len(lines)} lines")
        for p, line in zip(prompts, lines):
            got = [int(t) for t in line.split(",")]
            check(got[:len(p)] == p and len(p) < len(got) <= len(p) + 8,
                  "generate --int8: prompt not echoed or wrong length")
        # three prompts of one length decode as one batch: 2 groups
        gen_launches = q8_matmul.launches
        check(gen_launches == 2 * 8 * 7 * 2,
              f"generate --int8 launched q8_matmul {gen_launches} times, "
              f"expected 2 groups x 8 forwards x 7 x 2 layers")
        seqs = ["--token-ids", ",".join(map(str, prompts[3])),
                "--token-ids", ",".join(map(str, prompts[0]))]
        q8_matmul.launches = 0
        rc, q8_lines = run(score.main, ["--model", ckpt, *seqs, "--int8"])
        check(rc == 0 and q8_matmul.launches == 2 * 7 * 2,
              f"score --int8: exit {rc}, q8_matmul launches "
              f"{q8_matmul.launches}")
        rc, fp_lines = run(score.main, ["--model", ckpt, *seqs])
        check(rc == 0, f"score: exit {rc}")
        nll_q8, nll_fp = total_nll(q8_lines), total_nll(fp_lines)
        check(abs(nll_q8 - nll_fp) <= 0.05 * nll_fp,
              f"int8 nll/token {nll_q8} not within 5% of fp32 {nll_fp}")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["--model", ckpt, "--serve", "--int8"])
        check(rc == 2 and "--int8" in err.getvalue(),
              f"--serve --int8 returned {rc}")
        print(f"phase 12 cli over a 2-layer full-width checkpoint: generate "
              f"--int8 answered {len(lines)} prompts (q8_matmul launches "
              f"{gen_launches}); score nll/token int8 {nll_q8:.4f} vs fp32 "
              f"{nll_fp:.4f} ({abs(nll_q8 - nll_fp) / nll_fp:.2e} relative, "
              f"limit 0.05); --serve --int8 refused with exit 2")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def int8_kernel_lines(ctx) -> list[dict]:
    """q8_matmul at the path's largest decode call (wg/wi, m = batch, bf16
    x: the decode route) and its largest prefill call (wg/wi, m = batch x
    prompt: the tensor cores), replayed; the norms at 8192 bf16 rows of
    D = 1536."""
    lines = []
    for i, call in enumerate(("decode", "prefill")):
        x, w_q, scale = ctx["q8_captured"][call]
        m = measure_q8(ctx, x, w_q, scale, reps=10 if i == 0 else 5)
        print(f"q8_matmul at the int8 path's largest {call} call "
              f"(m={x.shape[0]} k={x.shape[1]} n={w_q.shape[1]} {x.dtype}, "
              f"route {m['route']}, grid {m['grid']}): max abs err "
              f"{m['max_abs_err']:.3g} ({m['of_limit']:.3f} of its limit); "
              f"kernel {m['ms'] * 1e3:.1f} us = {m['rate']}, plain "
              f"{m['plain_ms'] * 1e3:.1f} us, {m['library']} "
              f"{m['library_ms'] * 1e3:.1f} us, bound "
              f"{m['bound_ms'] * 1e3:.2f} us ({m['bound_by']}) "
              f"[{ctx['card']}]")
        lines.append({"name": f"q8_matmul_{call}", "route": "cuda",
                      "source": "tony_tpu_torch/csrc/q8_matmul.cu",
                      "replaces": "tony_tpu/ops/quant.py:42",
                      "launches": ctx["q8_launches"][i],
                      "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                      "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                      "bound_by": m["bound_by"],
                      "library_ms": m["library_ms"]})
    for i, (name, site) in enumerate((
            ("rmsnorm", "tony_tpu/ops/fused.py:19"),
            ("add_rmsnorm", "tony_tpu/ops/fused.py:26"))):
        r = ctx["norms"][(8192, 1536, "bfloat16")][name]
        lines.append({
            "name": name, "route": "cuda",
            "source": "tony_tpu_torch/csrc/fused_norms.cu",
            "replaces": site, "launches": ctx["norm_launches"][i],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    return lines


# ------------------------------------------------- serving options (13)

SPEC_K = 8            # 13a: bench.py's spec datum
PREFILL_CHUNK = 512   # 13c
FAULT_AT = 3          # 13e: the fault fires at the top of the 3rd step
# the near-tie rule: two streams may part only where the plain forward
# puts both chosen tokens' logits within this share of the row's largest
# |logit| (bf16's 2^-7 relative step, once for each of the two paths)
NEAR_TIE = 2.0 ** -6


def spec_specs(rng) -> list:
    """13a's 16 requests as (prompt, budget): a pattern of 5-16 random
    tokens repeated to 256-1024 tokens, budgets 64-256."""
    import numpy as np

    return [(np.resize(rng.integers(0, 151643, int(rng.integers(5, 17))),
                       int(rng.integers(256, 1025))).tolist(),
             int(rng.integers(64, 257))) for _ in range(16)]


def requests(specs) -> list:
    from tony_tpu_torch.serve import Request

    return [Request(list(p), n, id=i) for i, (p, n) in enumerate(specs)]


def near_ties(model, specs, got: dict, want: dict, part: str) -> list:
    """Hold the streams ``got`` to ``want`` (Results by id): equal, or
    parting first at a near tie. At the first token where two streams
    differ, one plain forward re-scores the common prefix, and both
    chosen tokens' logits must lie within ``NEAR_TIE`` x the row's
    largest |logit|. Returns (id, index, gap, tolerance) for each
    parting."""
    import torch

    ties = []
    for i, (prompt, _) in enumerate(specs):
        a, b = got[i].tokens, want[i].tokens
        tie = parting(model, prompt, a, b, f"{part} request {i}")
        if tie is None:
            check(got[i].finish_reason == want[i].finish_reason,
                  f"{part} request {i}: {got[i].finish_reason} against "
                  f"{want[i].finish_reason}")
        else:
            ties.append((i, *tie))
    return ties


def first_parting(model, prompt, a: list, b: list):
    """None when the token streams ``a`` and ``b`` (continuations of
    ``prompt``) agree where both run; else ``(index, gap, tolerance)``
    of their first parting: one plain forward over the common prefix
    gives the two tokens' logit gap, and the near-tie tolerance is
    ``NEAR_TIE`` x the row's largest |logit|."""
    import torch

    j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if j is None:
        return None
    seq = torch.tensor([list(prompt) + list(a[:j])], device=DEVICE)
    with torch.no_grad():
        hidden = model(seq, return_hidden=True)
        logits = model.logits(hidden[0, -1:])[0]
    return (j, abs(float(logits[a[j]] - logits[b[j]])),
            NEAR_TIE * float(logits.abs().max()))


def parting(model, prompt, a: list, b: list, what: str):
    """``first_parting`` held to the near-tie rule: None when the streams
    are equal, else their first parting, which must be a near tie."""
    tie = first_parting(model, prompt, a, b)
    if tie is None:
        check(len(a) == len(b), f"{what}: {len(a)} tokens against "
              f"{len(b)}")
        return None
    j, gap, tol = tie
    check(gap <= tol, f"{what}: the streams part at token {j} ({a[j]} "
          f"against {b[j]}), logit gap {gap:.4g} under the plain forward "
          f"> {tol:.4g}")
    return tie


def ties_text(ties, n: int) -> str:
    if not ties:
        return f"all {n} streams equal"
    return (f"{n - len(ties)} of {n} streams equal, {len(ties)} part at a "
            "near tie (" + ", ".join(
                f"request {i} at token {j}: gap {g:.3g} <= {t:.3g}"
                for i, j, g, t in ties) + ")")


def verify_replay_check(ctx, srv, rng) -> None:
    """13b: on 8 long repetitive requests after their first round, one
    verify round replayed and the same round run eagerly, on one saved
    pool state: ``emit``, ``accepted``, ``cont`` and the pool bytes
    bit-equal; then both timed (median of 3), and the requests served
    to the end."""
    import numpy as np
    import torch

    from tony_tpu_torch.serve import Request
    from tony_tpu_torch.serve.engine import _verify_chunk

    for i in range(8):
        srv.submit(Request(np.resize(rng.integers(0, 151643, 6),
                                     1500).tolist(), 64, id=f"v{i}"))
    srv.step()  # admits all 8 and runs their first round
    check(srv.n_active == 8, f"13b: {srv.n_active} of 8 live")
    s = srv.slots
    drafts = srv._collect_drafts()
    if drafts is None:  # no draft proposed: the round's layout is the same
        drafts = [np.full(4, s.last_token[i]) for i in range(8)]
    window, k_cont, cols, flat, _ = srv._prepare_verify(drafts)
    leaves = pool_leaves(srv)
    saved = [leaf.clone() for leaf in leaves]
    n = s.pool.n_pages

    def restore():
        for leaf, keep in zip(leaves, saved):
            leaf.copy_(keep)
        sync()

    def eager():
        return _verify_chunk(
            srv.model, s.cache, torch.as_tensor(flat, device=DEVICE),
            b=s.batch_size, window=window, cols=cols, n_steps=k_cont,
            eos_ids=srv.eos_ids).cpu().numpy()

    def replayed():
        return srv._run_verify(flat, window, k_cont, cols)

    key = ("verify", window, k_cont, cols)
    if key not in srv.graphs.entries:
        replayed()  # its first call: eager, then captured
        restore()
    want = eager()
    want_pool = [leaf[:n].clone() for leaf in leaves]
    restore()
    replays = srv.graphs.calls["verify", "replays"]
    got = replayed()
    check(srv.graphs.calls["verify", "replays"] == replays + 1,
          "13b: the verify round was not a replay")
    check((got == want).all(), "13b: replayed emit/accepted/cont differ "
          "from the eager round's")
    check(all(torch.equal(leaf[:n], w) for leaf, w in zip(leaves,
                                                           want_pool)),
          "13b: replayed verify round's pool bytes differ from the eager "
          "round's")
    del want_pool
    times = {"eager": [], "replayed": []}
    for _ in range(3):
        for name, run in (("eager", eager), ("replayed", replayed)):
            restore()
            t0 = time.perf_counter()
            run()
            times[name].append(time.perf_counter() - t0)
    # a chunk of the same depth on the same state, replayed, beside it
    k, ccols, cflat = srv._prepare_chunk()
    if ("decode", k, ccols) not in srv.graphs.entries:
        srv._run_chunk(cflat, k, ccols)
    times["chunk"] = []
    for _ in range(3):
        restore()
        t0 = time.perf_counter()
        srv._run_chunk(cflat, k, ccols)
        times["chunk"].append(time.perf_counter() - t0)
    restore()
    breakdown = {"verify": top_kernels(replayed),
                 "chunk": top_kernels(lambda: srv._run_chunk(cflat, k,
                                                             ccols))}
    restore()
    del saved
    ms = {name: statistics.median(t) * 1e3 for name, t in times.items()}
    accepted = int(want[:, window].sum())
    print(f"phase 13b one verify round (window {window}, {k_cont} continuation "
          f"steps, {cols} page columns, batch 8; {accepted} of "
          f"{sum(d.size for d in drafts if d is not None)} drafts accepted)"
          f" replayed and eager on one saved state: emit, accepted, cont "
          f"and pool bytes ({n} pages, junk page aside) bit-equal; median "
          f"of 3: eager {ms['eager']:.1f} ms, replayed "
          f"{ms['replayed']:.1f} ms; a chunk of {k} micro-steps on the same "
          f"state, replayed, {ms['chunk']:.1f} ms [{ctx['card']}]")
    for name, text in breakdown.items():
        print(f"phase 13b replayed {name}, torch.profiler: {text} "
              f"[{ctx['card']}]")
    while not srv.done:
        srv.step()


def top_kernels(fn, n: int = 6) -> str:
    """``fn`` once under torch.profiler (device activity only): its
    device time and the ``n`` kernels that took most of it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    rows = []
    for r in prof.key_averages():
        us = getattr(r, "self_device_time_total",
                     getattr(r, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, r.count, r.key))
    if not rows:
        return "no device time seen"
    rows.sort(reverse=True)
    total = sum(us for us, _, _ in rows)
    return f"{total * 1e-3:.2f} ms of device time; most: " + "; ".join(
        f"{key[:60]} x{count} {us * 1e-3:.2f} ms"
        for us, count, key in rows[:n])


def time_lm_head(ctx, srv) -> dict:
    """13c: a 512-token prefill window at positions 2560-3071 (a
    3000-token prompt's last intermediate chunk) through the pool,
    timed by CUDA events (median of 5, L2 flushed): the intermediate
    chunk without the LM head (``_paged_prefill_chunk``) and with every
    row's logits, and the final chunk's logits for the last row alone
    (``_prefill_last``) and for every row, then one picked."""
    import torch

    from tony_tpu_torch.serve.engine import (_bucket_pow2,
                                             _paged_prefill_chunk,
                                             _prefill_last)

    s, model = srv.slots, srv.model
    lb, start = PREFILL_CHUNK, 2560
    cols = min(_bucket_pow2(-(-(start + lb) // s.pool.page_size)),
               s.max_pages)
    while s.pool.available() < cols and srv.prefix.evict_one():
        pass
    pages = s.pool.alloc(cols)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    window = torch.randint(0, 151643, (lb,), device=DEVICE, generator=gen)
    positions = start + torch.arange(lb, device=DEVICE)
    table = torch.tensor(pages, device=DEVICE)
    last = torch.tensor([lb - 1], device=DEVICE)
    flat = torch.cat([window, positions, table, last])

    def full():
        return model(window[None], decode=True, positions=positions[None],
                     page_table=table[None], cache=s.cache)

    fns = {
        "chunk, no LM head": lambda: _paged_prefill_chunk(
            model, s.cache, flat[:-1], lb, cols),
        "chunk, every row's logits": full,
        "final, the last row's logits": lambda: _prefill_last(
            model, s.cache, flat, lb, cols),
        "final, every row's logits": lambda: full()[0].index_select(0,
                                                                    last),
    }
    with torch.no_grad():
        out = {name: cuda_time_ms(fn, 5, ctx["flush"])
               for name, fn in fns.items()}
    s.pool.unref(pages)
    return out


def phase_serving_options(ctx) -> None:
    import numpy as np
    import torch

    from tony_tpu_torch.models.transformer import Transformer
    from tony_tpu_torch.serve import FaultPlan, InjectedFault
    from tony_tpu_torch.ops.decode import flash_decode

    cfg = qwen_config(dtype=torch.bfloat16)
    model = Transformer(cfg, device=DEVICE).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    rng = np.random.default_rng(SEED + 13)
    specs = spec_specs(rng)
    card_ = ctx["card"]
    launches = 0

    def serve(part, passes, **options):
        """One server with ``options``; each of ``passes`` (request
        specs) served in turn on it and checked: the first cold (its
        keys' first calls and captures inside the timed run), the next
        with the keys the earlier ones captured. Returns the server and
        per pass (run, counters of the pass, tok/s, capture seconds)."""
        nonlocal launches
        srv = serve_server(model, **options)
        out, base = [], {}
        for i, specs_ in enumerate(passes):
            reqs = requests(specs_)
            run = serve_timed(srv, reqs)
            c = check_run(srv, reqs, run, f"{part} pass {i + 1}", base)
            launches += run["launches"]
            toks = sum(len(r.tokens) for r in run["results"].values())
            out.append((run, {k: v - base.get(k, 0) for k, v in c.items()},
                        toks / run["wall"],
                        c["graph_capture_s"] - base.get("graph_capture_s",
                                                        0.0)))
            base = c
        return srv, out

    def rounds(c) -> str:
        acc = c["spec_accepted"] / max(1, c["spec_drafted"])
        return (f"{c['dispatches']} rounds ({c['spec_rounds']} verify: "
                f"{c['spec_drafted']} drafted, {c['spec_accepted']} "
                f"accepted, rate {acc:.3f}; verify graphs "
                f"{c['graph_verify_captures']} captures, "
                f"{c['graph_verify_replays']} replays, "
                f"{c['graph_verify_eager']} eager)")

    # 13a: speculation on, then off; a cold pass, then a warm one of new
    # requests of the same shapes
    warm = spec_specs(rng)
    srv, spec = serve("13a", (specs, warm), speculate_k=SPEC_K)
    check(spec[0][1]["spec_rounds"] > 0, "13a: no verify round ran")
    verify_replay_check(ctx, srv, rng)
    del srv
    torch.cuda.empty_cache()
    srv, plain = serve("13a off", (specs, warm))
    del srv
    torch.cuda.empty_cache()
    for i, name in enumerate(("cold", "warm")):
        ties = near_ties(model, (specs, warm)[i], spec[i][0]["results"],
                         plain[i][0]["results"], f"13a {name}")
        (_, c, rate, cap), (_, c0, rate0, cap0) = spec[i], plain[i]
        print(f"phase 13a speculation, {name} pass, 16 greedy requests (a "
              f"5-16-token pattern repeated to 256-1024 tokens, budgets "
              f"64-256): speculate_k {SPEC_K} {rate:.1f} tok/s in "
              f"{rounds(c)}, {cap:.2f} s capturing; off {rate0:.1f} tok/s "
              f"in {c0['dispatches']} chunks, {cap0:.2f} s capturing; "
              f"{ties_text(ties, 16)} [{card_}]")
    spec, c_spec = spec[0][0], spec[0][1]  # 13a's cold pass, for 13d-e

    # 13c: four 3000-token prompts ahead of twelve short ones, chunked
    # prefill on and off, cold and warm
    def long_short():
        out = [(rng.integers(0, 151643, 3000).tolist(),
                int(rng.integers(32, 129))) for _ in range(4)]
        return out + [(rng.integers(0, 151643,
                                    int(rng.integers(32, 257))).tolist(),
                       int(rng.integers(32, 129))) for _ in range(12)]

    passes = (long_short(), long_short())
    runs = {}
    for chunk in (PREFILL_CHUNK, 0):
        srv, runs[chunk] = serve(f"13c chunk {chunk}", passes,
                                 prefill_chunk_tokens=chunk)
        if chunk:
            c = runs[chunk][0][1]
            check(c["prefill_chunked_requests"] == 4
                  and c["graph_prefill_chunk_replays"] > 0,
                  f"13c: {c['prefill_chunked_requests']} chunked prompts, "
                  f"{c['graph_prefill_chunk_replays']} chunk replays")
            head = time_lm_head(ctx, srv)
        del srv
        torch.cuda.empty_cache()
    for i, name in enumerate(("cold", "warm")):
        ties = near_ties(model, passes[i], runs[PREFILL_CHUNK][i][0]["results"],
                         runs[0][i][0]["results"], f"13c {name}")
        text = []
        for chunk in (PREFILL_CHUNK, 0):
            run, c, rate, cap = runs[chunk][i]
            p50, p99 = percentiles(run["first"][j] for j in range(4, 16))
            text.append(
                f"{f'chunks of {chunk}' if chunk else 'unchunked'}: short "
                f"requests' TTFT p50 {p50:.3f} s, p99 {p99:.3f} s, "
                f"{rate:.1f} tok/s, {c['dispatches']} rounds, "
                f"{c['prefill_chunk_dispatches']} chunk dispatches "
                f"({c['graph_prefill_chunk_captures']} intermediate keys "
                f"captured, {c['graph_prefill_chunk_replays']} replays), "
                f"{cap:.2f} s capturing")
        print(f"phase 13c chunked prefill, {name} pass, 4 prompts of 3000 "
              f"tokens then 12 of 32-256, budgets 32-128: "
              + "; ".join(text) + f"; {ties_text(ties, 16)} [{card_}]")
    print("phase 13c a 512-token window at positions 2560-3071, CUDA events: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in head.items())
          + f" [{card_}]")

    # 13d: speculation with in-dispatch EOS off
    srv, ((run, c, rate, _),) = serve("13d", (specs,), speculate_k=SPEC_K,
                                      in_dispatch_eos=False)
    del srv
    torch.cuda.empty_cache()
    ties = near_ties(model, specs, run["results"], spec["results"], "13d")
    print(f"phase 13d speculate_k {SPEC_K}, in-dispatch EOS off: {rate:.1f} tok/s "
          f"in {c['dispatches']} rounds ({c['spec_rounds']} verify); "
          f"wasted_steps {c['wasted_steps']} against 13a's "
          f"{c_spec['wasted_steps']}, frozen_steps {c['frozen_steps']} "
          f"against {c_spec['frozen_steps']}; {ties_text(ties, 16)} "
          f"against 13a [{card_}]")

    # 13e: a dispatch fault mid-run, reset, the same requests again
    srv = serve_server(model, speculate_k=SPEC_K,
                       fault_plan=FaultPlan.fail_at(FAULT_AT))
    for r in requests(specs):
        srv.submit(r)
    flash_decode.launches = 0
    before = []
    try:
        for _ in range(FAULT_AT):
            before += srv.step()
        raise PhaseError(f"13e: no fault in {FAULT_AT} steps")
    except InjectedFault:
        pass
    launches += flash_decode.launches
    live = srv.n_active
    check(live == 8 and not before, f"13e: {live} live and {len(before)} "
          "finished at the fault")
    srv.reset()
    base = srv.counters()
    pinned = len({p for e in srv.prefix._entries.values() for p in e.pages})
    check(base["kv_pages_reserved"] == 0
          and base["kv_pages_used"] == pinned,
          f"13e: after reset {base['kv_pages_reserved']} reserved, "
          f"{base['kv_pages_used']} used, {pinned} pinned by the store")
    reqs = requests(specs)
    run = serve_timed(srv, reqs)
    c = check_run(srv, reqs, run, "13e", base=base)
    launches += run["launches"]
    bad = [i for i in range(16)
           if run["results"][i].tokens != spec["results"][i].tokens]
    check(not bad, f"13e: requests {bad} differ from the unfaulted run")
    print(f"phase 13e fail_at({FAULT_AT}): InjectedFault out of step {FAULT_AT} "
          f"with {live} requests live, none finished; after reset() "
          f"{base['kv_pages_used']} pages used (all pinned by the prefix "
          f"store), 0 reserved; the 16 requests again: tokens equal to "
          f"13a's, {c['prefix_hits'] - base['prefix_hits']} prefix hits, "
          f"{c['graph_verify_replays'] - base['graph_verify_replays']} "
          f"verify replays, no page leaked [{card_}]")
    del srv, model
    torch.cuda.empty_cache()
    ctx["launches"] += launches
    print(f"phase 13 flash_decode launches over phase 13's runs: {launches}")


# ------------------------------------ unpaged and sliding-window serving (14)

# Mistral-7B-v0.1, https://huggingface.co/mistralai/Mistral-7B-v0.1
# config.json
MISTRAL_7B = {
    "model_type": "mistral", "architectures": ["MistralForCausalLM"],
    "hidden_size": 4096, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "intermediate_size": 14336, "vocab_size": 32000,
    "hidden_act": "silu", "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
    "tie_word_embeddings": False, "sliding_window": 4096,
    "max_position_embeddings": 32768, "bos_token_id": 1,
    "eos_token_id": 2, "torch_dtype": "bfloat16",
}
MISTRAL_MAX_LEN = 8192  # the smoke's cap (published: 32768)
MISTRAL_EOS = (2,)      # </s>
ROW_STORE_MB = 1024.0   # 14c: room for 8 Qwen2.5-1.5B rows of 117.4 MB
ROW_PREFILL_CHUNK = 1024  # 14b


def mistral_config(**overrides):
    from tony_tpu_torch.models.hf import llama_config

    return llama_config(MISTRAL_7B, max_seq_len=MISTRAL_MAX_LEN,
                        decode_attention="flash", **overrides)


def mistral_decode_call(ctx) -> dict:
    """14-kernel: flash-decode at Mistral-7B's windowed call (B=8, H=32,
    KVH=8, D=128, S=8192, window 4096, lengths 4200-6000, bf16 cache),
    held to ``decode_tolerance`` and timed beside its plain version,
    SDPA with the window mask and its bound."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 140)
    b, h, kvh, d = 8, 32, 8, 128
    q = torch.randn(b, h, d, device=DEVICE, generator=gen).bfloat16()
    k = torch.randn(b, MISTRAL_MAX_LEN, kvh, d, device=DEVICE,
                    generator=gen).bfloat16()
    v = torch.randn(b, MISTRAL_MAX_LEN, kvh, d, device=DEVICE,
                    generator=gen).bfloat16()
    length = torch.linspace(4200, 6000, b, device=DEVICE).round().int()
    window = MISTRAL_7B["sliding_window"]
    m = measure_decode(q, k, v, length, window, None, None, ctx["flush"])
    print(f"phase 14 flash_decode at Mistral-7B's call B=8 H=32 KVH=8 D=128 "
          f"S={MISTRAL_MAX_LEN} bf16 window={window}, lengths 4200-6000 "
          f"({m['route']}, {m['nsplit']} split(s)): max abs err "
          f"{m['max_abs_err']:.3g} (tol {m['rtol']:.3g}*|want| + "
          f"{m['atol']:.3g}, worst excess {m['excess']:.3g}); kernel "
          f"{m['ms'] * 1e3:.1f} us ({m['bound_ms'] / m['ms']:.3f} of the "
          f"bound), plain {m['plain_ms'] * 1e3:.1f} us, sdpa "
          f"{m['library_ms'] * 1e3:.1f} us, bound "
          f"{m['bound_ms'] * 1e3:.2f} us ({m['bound_by']}) [{ctx['card']}]")
    del q, k, v
    return m


def mistral_specs(rng) -> list:
    """14a's 16 requests as (prompt, budget), long and short in turn: 8
    prompts of 4200-6000 tokens (the window in force from the first
    decode step) and 8 of 64-1024, budgets 64-256."""
    out = []
    for _ in range(8):
        for lo, hi in ((4200, 6001), (64, 1025)):
            out.append((rng.integers(0, 32000, int(rng.integers(lo, hi)))
                        .tolist(), int(rng.integers(64, 257))))
    return out


def mistral_probe(ctx, srv, rng) -> None:
    """14a's breakdown, untimed, on 14b's server after its run, by CUDA
    events (L2 flushed): one unchunked prefill of a 6000-token prompt
    (bucket 8192) and one 1024-token chunk at positions 4096-5119 into
    a free slot's row; then, with 8 live requests of 4500-token
    prompts (every row's window full), one replayed chunk of 8
    micro-steps (a chunk replayed again from its own end state writes
    the same bytes), beside a micro-step's bound: every weight byte
    but the embedding table's, and each row's 4096 visible K/V
    positions, over 3.35 TB/s."""
    import torch

    from tony_tpu_torch.serve import Request
    from tony_tpu_torch.serve.engine import _prefill_rows

    model, s, cfg = srv.model, srv.slots, srv.model.cfg
    flush = ctx["flush"]
    max_len, win, take = cfg.max_seq_len, cfg.sliding_window, \
        srv.prefill_chunk
    window = torch.as_tensor(rng.integers(0, 32000, max_len),
                             device=DEVICE)[None]
    with torch.no_grad():
        prefill_ms = cuda_time_ms(lambda: _prefill_rows(
            model, s.cache, 0, window, 0, min(6000, max_len) - 1), 1, flush)
        chunk_ms = cuda_time_ms(lambda: _prefill_rows(
            model, s.cache, 0, window[:, :take], win, None), 3, flush)
    for i in range(8):
        srv.submit(Request(rng.integers(0, 32000, min(
            4500, max_len - 100)).tolist(), 64, id=f"probe{i}"))
    while srv.n_active < 8 or srv.n_prefilling:
        srv.step()
    check(s.n_active == 8, f"14a probe: {s.n_active} of 8 live")
    k, cols, flat = srv._prepare_chunk()
    srv._run_chunk(flat, k, cols)  # the key's capture, if new
    decode_ms = cuda_time_ms(lambda: srv._run_chunk(flat, k, cols), 3,
                             flush)
    nbytes = sum(p.numel() * p.element_size()
                 for n, p in model.named_parameters() if n != "embedding")
    nbytes += 8 * win * cfg.n_layers * 2 * cfg.kv_heads * cfg.head_dim * 2
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    while not srv.done:
        srv.step()
    print(f"phase 14a probe (untimed, CUDA events): an unchunked prefill "
          f"of a 6000-token prompt (bucket 8192) {prefill_ms:.1f} ms; a "
          f"1024-token chunk at positions 4096-5119 {chunk_ms:.1f} ms; a "
          f"replayed chunk of {k} micro-steps at batch 8 with full "
          f"windows {decode_ms:.1f} ms = {decode_ms / k:.2f} ms a "
          f"micro-step against a bound of {bound:.2f} ms "
          f"({nbytes / 1e9:.2f} GB) [{ctx['card']}]")


def phase_unpaged_mistral(ctx) -> None:
    """14-kernel, then 14a and 14b: Mistral-7B-v0.1 at full width and
    depth through ``Server(paged=None)``, unchunked and with 1024-token
    prefill chunks; two 14a streams held against greedy decoding by the
    plain full forward (teacher-forced, the window mask), 14b's streams
    against 14a's."""
    import numpy as np
    import torch

    from tony_tpu_torch.models.transformer import Transformer
    from tony_tpu_torch.serve import Server

    card_ = ctx["card"]
    ctx["mistral_call"] = mistral_decode_call(ctx)
    torch.cuda.empty_cache()
    cfg = mistral_config(dtype=torch.bfloat16)
    model = Transformer(cfg, device=DEVICE).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    specs = mistral_specs(np.random.default_rng(SEED + 14))
    runs = {}
    launches = 0
    for chunk in (0, ROW_PREFILL_CHUNK):
        part = "14b" if chunk else "14a"
        srv = Server(model, batch_size=8, eos_id=MISTRAL_EOS, chunk_steps=8,
                     prefill_chunk_tokens=chunk, device=DEVICE)
        check(not srv.paged and srv.prefix is None,
              f"{part}: Server(paged=None) over a sliding-window model is "
              "paged or has a prefix store")
        torch.cuda.reset_peak_memory_stats()
        reqs = requests(specs)
        run = serve_timed(srv, reqs)
        c = check_run(srv, reqs, run, part)
        peak = torch.cuda.max_memory_allocated()
        launches += run["launches"]
        if chunk:
            check(c["prefill_chunked_requests"] == 8,
                  f"14b: {c['prefill_chunked_requests']} of 8 long prompts "
                  "chunked")
        toks = sum(len(r.tokens) for r in run["results"].values())
        p50, p99 = percentiles(run["first"][r.id] for r in reqs)
        print(f"phase {part} serve Mistral-7B-v0.1 bf16 ({n_params} params, "
              f"{cfg.n_layers} layers, window {cfg.sliding_window}, "
              f"max_seq_len {cfg.max_seq_len}) unpaged, batch 8, "
              f"{'prefill chunks of %d' % chunk if chunk else 'unchunked'}, "
              f"16 greedy requests (8 of 4200-6000 tokens, 8 of 64-1024): "
              f"{toks} tokens in {run['wall']:.2f} s = "
              f"{toks / run['wall']:.1f} tok/s; TTFT p50 {p50:.3f} s, p99 "
              f"{p99:.3f} s; {c['decode_steps']} micro-steps in "
              f"{c['dispatches']} chunks ({c['graph_chunk_rows_captures']} "
              f"keys captured, {c['graph_chunk_rows_replays']} replays, "
              f"{c['graph_capture_s']:.2f} s capturing), "
              f"{c['graph_prefill_rows_eager']} eager prefill calls "
              f"({c['prefill_chunk_dispatches']} of them chunks); "
              f"flash_decode launches {run['launches']} = {cfg.n_layers} x "
              f"{c['decode_steps']}; peak memory {peak / 2**30:.2f} GiB "
              f"[{card_}]")
        runs[chunk] = run
        if chunk:
            mistral_probe(ctx, srv, np.random.default_rng(SEED + 143))
        del srv
        torch.cuda.empty_cache()
    ctx["launches"] += launches
    ctx["mistral_launches"] = launches
    ties = near_ties(model, specs, runs[ROW_PREFILL_CHUNK]["results"],
                     runs[0]["results"], "14b")
    print(f"phase 14b against 14a: {ties_text(ties, 16)} [{card_}]")
    # two streams, one long and one short, against the plain forward
    text = []
    for i in (0, 1):
        prompt = specs[i][0]
        got = runs[0]["results"][i].tokens
        seq = torch.tensor([prompt + got[:-1]], device=DEVICE)
        with torch.no_grad():
            hidden = model(seq, return_hidden=True)
            plain = model.logits(hidden[0, len(prompt) - 1:])
        want = plain.argmax(dim=-1).tolist()
        j = next((n for n, (a, w) in enumerate(zip(got, want)) if a != w),
                 None)
        del hidden, plain
        if j is None:
            text.append(f"request {i} ({len(prompt)}-token prompt): all "
                        f"{len(got)} tokens equal")
            continue
        tie = parting(model, prompt, got, got[:j] + [want[j]],
                      f"14a request {i} against the plain forward")
        text.append(f"request {i} ({len(prompt)}-token prompt): parts at "
                    f"token {j}, gap {tie[1]:.3g} <= {tie[2]:.3g}")
    print("phase 14a two streams against greedy decoding by the plain full "
          "forward (window mask): " + "; ".join(text) + f" [{card_}]")
    del model
    torch.cuda.empty_cache()


def rows_replay_check(ctx, srv, rng) -> None:
    """14d: on 8 live 1500-token requests after their first chunk, one
    unpaged chunk replayed and the same chunk run eagerly on one saved
    resident-cache state: tokens and cache bytes bit-equal; both timed
    (median of 3); then the requests served to the end."""
    import torch

    from tony_tpu_torch.serve import Request
    from tony_tpu_torch.serve.engine import _decode_chunk

    for i in range(8):
        srv.submit(Request(rng.integers(0, 151643, 1500).tolist(), 64,
                           id=f"rows{i}"))
    srv.step()
    check(srv.n_active == 8, f"14d: {srv.n_active} of 8 live")
    s = srv.slots
    k, cols, flat = srv._prepare_chunk()
    leaves = pool_leaves(srv)
    saved = [leaf.clone() for leaf in leaves]

    def restore():
        for leaf, keep in zip(leaves, saved):
            leaf.copy_(keep)
        sync()

    def eager():
        return _decode_chunk(
            srv.model, s.cache, torch.as_tensor(flat, device=DEVICE),
            b=s.batch_size, cols=0, n_steps=k,
            eos_ids=srv.eos_ids).cpu().numpy()

    def replayed():
        return srv._run_chunk(flat, k, cols)

    if ("chunk_rows", k) not in srv.graphs.entries:
        replayed()
        restore()
    want = eager()
    want_cache = [leaf.clone() for leaf in leaves]
    restore()
    replays = srv.graphs.calls["chunk_rows", "replays"]
    got = replayed()
    check(srv.graphs.calls["chunk_rows", "replays"] == replays + 1,
          "14d: the chunk was not a replay")
    check((got == want).all(), "14d: replayed chunk tokens differ from the "
          "eager chunk's")
    check(all(torch.equal(leaf, w) for leaf, w in zip(leaves, want_cache)),
          "14d: replayed chunk cache bytes differ from the eager chunk's")
    del want_cache
    times = {"eager": [], "replayed": []}
    for _ in range(3):
        for name, fn in (("eager", eager), ("replayed", replayed)):
            restore()
            t0 = time.perf_counter()
            fn()
            times[name].append(time.perf_counter() - t0)
    restore()
    del saved
    ms = {name: statistics.median(t) * 1e3 for name, t in times.items()}
    print(f"phase 14d one unpaged chunk ({k} micro-steps, batch 8 at "
          f"1500-token prompts, {s.max_seq_len}-position rows) replayed "
          f"and eager on one saved state: tokens and cache bytes "
          f"bit-equal; median of 3: eager {ms['eager']:.1f} ms, replayed "
          f"{ms['replayed']:.1f} ms [{ctx['card']}]")
    while not srv.done:
        srv.step()


def unpaged_fp32_gate(ctx, specs) -> None:
    """14c's gate: Qwen2.5-1.5B in fp32 (phase 4's weights, cast), phase
    4's traffic paged and unpaged: every stream and finish reason
    equal. (In bf16 the two paths' prefills and flash-decode splits
    round differently, so their streams part, each at its own token;
    the bf16 pass prints where.)"""
    import torch

    from tony_tpu_torch.models.transformer import Transformer

    model = Transformer(qwen_config(dtype=torch.float32),
                        device=DEVICE).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    out = {}
    for name, opts in (("paged", {}), ("unpaged", {
            "paged": False, "prefix_cache_mb": ROW_STORE_MB})):
        srv = serve_server(model, **opts)
        reqs = requests(specs)
        run = serve_timed(srv, reqs)
        check_run(srv, reqs, run, f"14c fp32 {name}")
        ctx["launches"] += run["launches"]
        out[name] = {i: (r.tokens, r.finish_reason)
                     for i, r in run["results"].items()}
        del srv
        torch.cuda.empty_cache()
    bad = [i for i in out["paged"] if out["paged"][i] != out["unpaged"][i]]
    check(not bad, f"14c fp32: unpaged streams {bad} differ from paged")
    print(f"phase 14c fp32 (TF32 off), phase 4's first {len(specs)} "
          f"requests: unpaged streams and finish reasons equal to paged in "
          f"all {len(specs)} [{ctx['card']}]")
    del model
    torch.cuda.empty_cache()


def phase_unpaged_qwen(ctx) -> None:
    """14c, 14d and 14e on Qwen2.5-1.5B bf16 (phase 4's weights): phase
    4's traffic through ``paged=False`` with a row prefix store (where
    the streams part from phase 4's printed, not held: the fp32 gate
    holds them), then exact hits, then speculation at 13a's traffic;
    one unpaged chunk replayed against eager; ``generate`` with the
    repetition penalty and ``beam_search``."""
    import numpy as np
    import torch

    from tony_tpu_torch.models.generate import (_generate_eager,
                                                beam_search, generate)
    from tony_tpu_torch.models.transformer import Transformer
    from tony_tpu_torch.serve import Request

    card_ = ctx["card"]
    cfg = qwen_config(dtype=torch.bfloat16)
    model = Transformer(cfg, device=DEVICE).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    launches = 0
    s4 = ctx["serve4"]
    srv = serve_server(model, paged=False, prefix_cache_mb=ROW_STORE_MB)
    check(not srv.paged and srv.prefix is not None,
          "14c: unpaged server without its row store")
    reqs = requests(s4["specs"])
    run = serve_timed(srv, reqs)
    c = check_run(srv, reqs, run, "14c")
    launches += run["launches"]
    check(c["prefix_hits"] > 0, "14c: the row store recorded no hit")
    parts = [first_parting(model, p, run["results"][i].tokens,
                           s4["results"][i].tokens)
             for i, (p, _) in enumerate(s4["specs"])]
    ratios = sorted(t[1] / t[2] for t in parts if t is not None)
    toks = sum(len(r.tokens) for r in run["results"].values())
    p50, p99 = percentiles(run["first"][r.id] for r in reqs)
    print(f"phase 14c serve Qwen2.5-1.5B bf16 paged=False, phase 4's 24 "
          f"requests, row store {ROW_STORE_MB:.0f} MB: {toks / run['wall']:.1f}"
          f" tok/s (phase 4 paged {s4['rate']:.1f}); TTFT p50 {p50:.3f} s, "
          f"p99 {p99:.3f} s (phase 4 {s4['ttft'][0]:.3f}, "
          f"{s4['ttft'][1]:.3f}); prefix hits {c['prefix_hits']} "
          f"({c['prefix_hit_tokens']} tokens), {c['prefix_entries']} rows "
          f"stored, {c['prefix_evictions']} evicted; "
          f"{c['graph_chunk_rows_captures']} chunk keys captured, "
          f"{c['graph_chunk_rows_replays']} replays, "
          f"{c['graph_capture_s']:.2f} s capturing, "
          f"{c['graph_prefill_rows_eager']} eager prefills; against phase "
          f"4's bf16 streams: {24 - len(ratios)} of 24 equal"
          + (f", the others part at tokens "
             f"{sorted(t[0] for t in parts if t is not None)} with logit "
             f"gaps of {', '.join(f'{r:.3f}' for r in ratios)} x the "
             f"near-tie tolerance" if ratios else "") + f" [{card_}]")
    # the fp32 gate at half of phase 4's traffic (the smoke's time)
    unpaged_fp32_gate(ctx, s4["specs"][:12])
    # exact hits: four prompts served, then served again
    rng = np.random.default_rng(SEED + 141)
    again = [(rng.integers(0, 151643, int(rng.integers(300, 801))).tolist(),
              32) for _ in range(4)]
    outs = []
    for n in range(2):
        base = srv.counters()
        reqs = requests(again)
        run = serve_timed(srv, reqs)
        check_run(srv, reqs, run, f"14c exact pass {n + 1}", base)
        launches += run["launches"]
        outs.append(run["results"])
    exact = [r for r in outs[1].values()
             if r.prefix_hit_tokens == len(r.prompt) and
             r.prefill_chunks == 0]
    check(len(exact) == 4, f"14c: {len(exact)} of 4 repeats hit exactly")
    ties = near_ties(model, again, outs[1], outs[0], "14c exact")
    print(f"phase 14c exact hits: 4 prompts of 300-800 tokens served twice, "
          f"the second time 4 exact hits (no prefill): "
          f"{ties_text(ties, 4)} [{card_}]")
    rows_replay_check(ctx, srv, rng)
    del srv
    torch.cuda.empty_cache()
    # one speculative pass at half of 13a's traffic: the unpaged verify
    # round
    specs = spec_specs(np.random.default_rng(SEED + 13))[:8]
    srv = serve_server(model, paged=False, prefix_cache_mb=ROW_STORE_MB,
                       speculate_k=SPEC_K)
    reqs = requests(specs)
    run = serve_timed(srv, reqs)
    c = check_run(srv, reqs, run, "14c speculation")
    launches += run["launches"]
    check(c["spec_rounds"] > 0 and c["graph_verify_rows_replays"] > 0,
          f"14c: {c['spec_rounds']} verify rounds, "
          f"{c['graph_verify_rows_replays']} replayed")
    toks = sum(len(r.tokens) for r in run["results"].values())
    print(f"phase 14c speculate_k {SPEC_K} unpaged at 13a's first "
          f"{len(specs)} requests: "
          f"{toks / run['wall']:.1f} tok/s, {c['spec_rounds']} verify "
          f"rounds of {c['dispatches']} ({c['spec_drafted']} drafted, "
          f"{c['spec_accepted']} accepted; verify graphs "
          f"{c['graph_verify_rows_captures']} captures, "
          f"{c['graph_verify_rows_replays']} replays), "
          f"{c['graph_capture_s']:.2f} s capturing [{card_}]")
    del srv
    torch.cuda.empty_cache()
    ctx["launches"] += launches
    print(f"phase 14c-d flash_decode launches: {launches}")

    # 14e: generate with the repetition penalty, and beam search
    prompt = torch.as_tensor(rng.integers(0, 151643, (2, 512)),
                             device=DEVICE)
    n_new = 64
    greedy = generate(model, prompt, max_new_tokens=n_new,
                      eos_id=SERVE_EOS)
    one = generate(model, prompt, max_new_tokens=n_new, eos_id=SERVE_EOS,
                   repetition_penalty=1.0)
    check(torch.equal(one, greedy), "14e: repetition_penalty 1.0 changed "
          "greedy tokens")
    sync()
    t0 = time.perf_counter()
    pen = generate(model, prompt, max_new_tokens=n_new, eos_id=SERVE_EOS,
                   repetition_penalty=1.3)
    sync()
    pen_s = time.perf_counter() - t0
    pen_eager = _generate_eager(model, prompt, n_new,
                                lambda x: torch.argmax(x, dim=-1),
                                SERVE_EOS, repetition_penalty=1.3)
    check(torch.equal(pen, pen_eager), "14e: replayed generate with the "
          "penalty differs from the eager one")
    distinct = [len(set(x[r].tolist())) for x in (pen, greedy)
                for r in range(2)]
    k1 = beam_search(model, prompt, max_new_tokens=n_new, num_beams=1,
                     eos_id=SERVE_EOS)
    ties = [parting(model, prompt[r].tolist(), k1[r].tolist(),
                    greedy[r].tolist(), f"14e num_beams=1 row {r}")
            for r in range(2)]
    sync()
    t0 = time.perf_counter()
    beams = beam_search(model, prompt, max_new_tokens=n_new, num_beams=4,
                        eos_id=SERVE_EOS)
    sync()
    beam_s = time.perf_counter() - t0
    check(beams.shape == (2, n_new) and bool((beams >= 0).all())
          and bool((beams < cfg.vocab_size).all()),
          f"14e: beam output {tuple(beams.shape)}")
    beam_calls = model.graphs.counters(("beam",))["beam_eager"]
    print(f"phase 14e generate Qwen2.5-1.5B bf16, batch 2, 512-token "
          f"prompts, {n_new} tokens: repetition_penalty 1.3 replayed "
          f"{2 * n_new / pen_s:.1f} tok/s, equal to eager; 1.0 equal to "
          f"no penalty; distinct tokens a row {distinct[:2]} (1.3) "
          f"against {distinct[2:]} (none); num_beams=1 against greedy: "
          + ", ".join("equal" if t is None else
                      f"parts at token {t[0]} (gap {t[1]:.3g} <= {t[2]:.3g})"
                      for t in ties)
          + f"; beam_search num_beams=4 {2 * n_new / beam_s:.1f} tok/s "
          f"({beam_calls} eager beam steps, cache reordered by "
          f"index_select each step) [{card_}]")
    del model
    torch.cuda.empty_cache()


def cli_one_shot(ckpt: str, ids: list, *flags) -> list:
    """``cli.generate --token-ids`` over ``ckpt``: the printed lines, each
    checked to echo its prompt."""
    from tony_tpu_torch.cli import generate as cli

    out = io.StringIO()
    argv = ["--model", ckpt, "--device", DEVICE, "--max-new-tokens", "16",
            *flags]
    for p in ids:
        argv += ["--token-ids", ",".join(map(str, p))]
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    check(rc == 0, f"cli {flags}: exit code {rc}")
    lines = out.getvalue().strip().splitlines()
    check(len(lines) == len(ids), f"cli {flags}: {len(lines)} lines")
    for line, p in zip(lines, ids):
        got = [int(x) for x in line.split(",")]
        check(got[:len(p)] == p and len(p) < len(got) <= len(p) + 16,
              f"cli {flags}: {len(got)} ids for a {len(p)}-token prompt")
    return lines


def phase_unpaged_cli(ctx) -> None:
    """14f: ``cli.generate --serve`` over a 2-layer full-width Mistral
    checkpoint (unpaged and no prefix store, each with its note); then
    over phase 5's checkpoint ``--no-paged-kv`` against paged (fp32,
    equal), and one-shot ``--num-beams 4`` and ``--repetition-penalty
    1.3``."""
    import numpy as np

    rng = np.random.default_rng(SEED + 142)
    ckpt = write_checkpoint(MISTRAL_7B)
    try:
        lines = [{"id": f"m{i}", "token_ids": rng.integers(
                     0, 32000, n).tolist(), "max_new_tokens": m}
                 for i, (n, m) in enumerate(((40, 12), (300, 20), (5, 1),
                                             (900, 8)))]
        err = io.StringIO()
        got = serve_cli(ckpt, lines, "--dtype", "bf16", err=err)
        notes = [n for n in ("paged KV cache disabled",
                             "prefix cache disabled") if n in err.getvalue()]
        check(len(notes) == 2, f"14f: notes {notes} in {err.getvalue()!r}")
        print(f"phase 14f cli --serve over a 2-layer full-width Mistral-7B "
              f"checkpoint: {len(got)} responses checked; notes: "
              + "; ".join(notes))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    ckpt = write_checkpoint()
    try:
        lines = [{"id": f"q{i}", "token_ids": rng.integers(
                     0, 151643, n).tolist(), "max_new_tokens": m}
                 for i, (n, m) in enumerate(((40, 12), (300, 20), (5, 1),
                                             (900, 8)))]
        paged = serve_cli(ckpt, lines, "--dtype", "fp32")
        rows = serve_cli(ckpt, lines, "--dtype", "fp32", "--no-paged-kv")
        check(rows == paged, "14f --no-paged-kv: responses differ from the "
              "paged run: " + ", ".join(k for k in paged
                                        if rows[k] != paged[k]))
        ids = [rng.integers(0, 151643, n).tolist() for n in (20, 33)]
        beams = cli_one_shot(ckpt, ids, "--num-beams", "4")
        pen = cli_one_shot(ckpt, ids, "--repetition-penalty", "1.3")
        print(f"phase 14f cli over phase 5's checkpoint: --serve "
              f"--no-paged-kv (fp32) {len(rows)} responses equal to the "
              f"paged run; one-shot --num-beams 4 and --repetition-penalty "
              f"1.3: {len(beams)} + {len(pen)} lines checked")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


# ------------------------------------------------------- the gateway (15)


def http_generate(url: str, prompt: list, budget: int, stream: bool,
                  rid) -> dict:
    """One ``POST /v1/generate``; its status must be 200. Returns the
    last line's document; a stream's deltas must spell its tokens."""
    import urllib.request

    body = json.dumps({"id": rid, "token_ids": list(prompt),
                       "max_new_tokens": budget, "stream": stream})
    req = urllib.request.Request(url + "/v1/generate", data=body.encode())
    with urllib.request.urlopen(req, timeout=600) as r:
        check(r.status == 200, f"request {rid}: status {r.status}")
        lines = [json.loads(ln) for ln in r.read().decode().splitlines()
                 if ln.strip()]
    last = lines[-1]
    if stream:
        deltas = [t for ln in lines[:-1] for t in ln["token_ids"]]
        check(deltas == last["token_ids"][len(prompt):],
              f"request {rid}: the streamed deltas differ from the final "
              "tokens")
    return last


def http_json(url: str, path: str):
    import urllib.request

    with urllib.request.urlopen(url + path, timeout=60) as r:
        check(r.status == 200, f"GET {path}: status {r.status}")
        body = r.read().decode()
    return body if path == "/metrics" else json.loads(body)


class Streamed:
    """A gateway response as ``near_ties`` reads a Result."""

    def __init__(self, doc, prompt):
        self.tokens = doc["token_ids"][len(prompt):]
        self.finish_reason = doc["finish_reason"]


def gateway_pass(url: str, specs: list, tag: str) -> tuple:
    """``specs`` sent at once by one HTTP client each, every second
    streamed; returns (final documents by request index, wall seconds
    from the synchronised start to the last response)."""
    from concurrent.futures import ThreadPoolExecutor

    sync()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(specs)) as ex:
        futs = [ex.submit(http_generate, url, p, n, i % 2 == 1,
                          f"{tag}{i}") for i, (p, n) in enumerate(specs)]
        docs = [f.result() for f in futs]
    sync()
    return docs, time.perf_counter() - t0


def phase_gateway(ctx) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import tony_tpu_torch.models.graphs as graphs_mod
    from tony_tpu_torch.gateway import Gateway, GatewayEdge
    from tony_tpu_torch.models.transformer import Transformer
    from tony_tpu_torch.ops.decode import flash_decode

    cfg = qwen_config(dtype=torch.bfloat16)
    model = Transformer(cfg, device=DEVICE).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    servers = [serve_server(model) for _ in range(2)]
    # each replica's capture windows, to show the cold starts overlap
    spans = {id(s.graphs.backend): [] for s in servers}
    real_capture = graphs_mod.CudaGraphs.capture

    def capture(self, fn, statics):
        t0 = time.perf_counter()
        try:
            return real_capture(self, fn, statics)
        finally:
            spans[id(self)].append((t0, time.perf_counter()))

    graphs_mod.CudaGraphs.capture = capture
    gw = Gateway(servers, max_queue=64).start()
    edge = GatewayEdge(gw, host="127.0.0.1", port=0).start()
    url = f"http://127.0.0.1:{edge.port}"
    specs = ctx["serve4"]["specs"]
    try:
        flash_decode.launches = 0
        t_start = time.perf_counter()
        docs, wall = gateway_pass(url, specs, "g")
        t_cold = time.perf_counter()
        launches = flash_decode.launches
        stats = http_json(url, "/stats")
        metrics = http_json(url, "/metrics")
        cs = [s.counters() for s in servers]
        warm_docs, warm_wall = gateway_pass(url, specs, "w")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            gateway_pass(url, specs, "p")
    finally:
        graphs_mod.CudaGraphs.capture = real_capture
        ok = gw.drain(timeout=600)
        edge.stop()
    check(ok, "15a: the gateway's drain timed out")
    got = {i: Streamed(d, specs[i][0]) for i, d in enumerate(docs)}
    want = ctx["serve4"]["results"]
    ties = near_ties(model, specs, got, want, "15a")
    warm = {i: Streamed(d, specs[i][0]) for i, d in enumerate(warm_docs)}
    warm_ties = near_ties(model, specs, warm, want, "15a warm pass")
    warm_gen = sum(len(g.tokens) for g in warm.values())
    micro = sum(c["decode_steps"] - c["spec_window_steps"] for c in cs)
    check(launches == cfg.n_layers * micro > 0,
          f"15a: flash_decode launched {launches} times, expected "
          f"{cfg.n_layers} x {micro} micro-steps of both replicas")
    ctx["launches"] += launches
    for i, c in enumerate(cs):
        check(c["kv_pages_reserved"] == 0 and c["freeze_faults"] == 0,
              f"15a replica {i}: {c['kv_pages_reserved']} pages reserved, "
              f"{c['freeze_faults']} freeze faults")
        for kind in ("decode", "prefill"):
            check(c[f"graph_{kind}_eager"] == 0,
                  f"15a replica {i}: {c[f'graph_{kind}_eager']} eager "
                  f"{kind} calls")
        check(c["graph_decode_captures"] > 0,
              f"15a replica {i} captured no chunk graph")
    cold = [[(a, b) for a, b in v if a < t_cold] for v in spans.values()]
    windows = [(min(a for a, _ in v) - t_start, max(b for _, b in v)
                - t_start) for v in cold]
    overlap = windows[0][0] < windows[1][1] and windows[1][0] < windows[0][1]
    pct = []
    for row in stats["replicas"]:
        util = (row.get("goodput") or {}).get("utilization") or {}
        pct += [u["hbm_bw_pct"] for u in util.values()
                if u.get("hbm_bw_pct") is not None]
    check(pct and all(0.0 <= x <= 100.0 for x in pct),
          f"15a: /stats goodput HBM-BW% {pct} not all within 0-100")
    check("tony_goodput_fraction" in metrics,
          "15a: /metrics has no tony_goodput_fraction")
    buckets = stats["engine"]["goodput"]["buckets"]
    gen = sum(len(g.tokens) for g in got.values())
    ttft = sorted(d["metrics"]["ttft_ms"] / 1e3 for d in docs)
    p50, p99 = percentiles(ttft)
    dev_us, ops = device_busy(prof)
    host = "not measured" if dev_us <= 0 else \
        f"{max(0.0, 1.0 - dev_us * 1e-6 / warm_wall):.3f}"
    s4 = ctx["serve4"]
    print(f"phase 15a gateway, 2 replicas x batch 8 of phase 4's "
          f"configuration behind GatewayEdge, cold, 24 HTTP clients (12 "
          f"NDJSON streams): {gen} tokens in {wall:.2f} s = "
          f"{gen / wall:.1f} tok/s (phase 4, one Server: "
          f"{s4['rate']:.1f}); TTFT p50 {p50:.3f} s, p99 {p99:.3f} s "
          f"(phase 4: {s4['ttft'][0]:.3f} / {s4['ttft'][1]:.3f} s); "
          f"{ties_text(ties, len(specs))} [{ctx['card']}]")
    print(f"phase 15a captures: replica 0 "
          f"{cs[0]['graph_decode_captures']} chunk + "
          f"{cs[0]['graph_prefill_captures']} prefill keys in "
          f"{cs[0]['graph_capture_s']:.2f} s, replica 1 "
          f"{cs[1]['graph_decode_captures']} + "
          f"{cs[1]['graph_prefill_captures']} in "
          f"{cs[1]['graph_capture_s']:.2f} s; capture windows "
          + ", ".join(f"[{a:.2f}, {b:.2f}] s" for a, b in windows)
          + (" overlap" if overlap else " do not overlap")
          + f"; flash_decode launches {launches} = {cfg.n_layers} x "
          f"{micro}; requests by replica "
          f"{[c['prefills'] for c in cs]} prefills [{ctx['card']}]")
    print(f"phase 15a warm pass: {warm_gen / warm_wall:.1f} tok/s in "
          f"{warm_wall:.2f} s, against phase 4: "
          f"{ties_text(warm_ties, len(specs))}; host share of wall {host} (device busy "
          f"{dev_us * 1e-3:.1f} ms in {ops} device ops over a profiled "
          f"warm pass) [{ctx['card']}]")
    print(f"phase 15a capture cost, both replicas: "
          f"{capture_text(*(s.graphs for s in servers))} [{ctx['card']}]")
    print("phase 15a goodput buckets (fleet, at the end of the cold "
          "pass): "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(buckets.items()))
          + f"; HBM-BW% by replica and kind {pct} [{ctx['card']}]")
    del gw, servers, model, prof
    torch.cuda.empty_cache()


def phase_gateway_cli(ctx) -> None:
    """15b: the gateway CLI over phase 5's checkpoint, as a subprocess,
    against one fp32 Server on the same checkpoint."""
    import numpy as np
    import torch

    from tony_tpu_torch.models.hf import load_llama_dir
    from tony_tpu_torch.serve import Request, Server

    ckpt = write_checkpoint()
    proc = None
    try:
        rng = np.random.default_rng(SEED + 2)
        specs = [(rng.integers(0, 151643, n).tolist(), m)
                 for n, m in ((40, 12), (300, 20), (5, 1), (900, 8))]
        # the gateway CLI's defaults on the card: flash-decode, batch 4,
        # chunks of 1, a 64 MB prefix store, the config's end-of-text id
        model, _ = load_llama_dir(ckpt, device=DEVICE,
                                  decode_attention="flash")
        srv = Server(model, batch_size=4, chunk_steps=1,
                     eos_id=QWEN25_15B["eos_token_id"],
                     prefix_cache_mb=64.0, device=DEVICE)
        want = {r.id: r for r in srv.run(
            [Request(list(p), n, id=i) for i, (p, n) in enumerate(specs)])}
        del srv, model
        torch.cuda.empty_cache()
        proc = subprocess.Popen(
            [sys.executable, "-m", "tony_tpu_torch.cli.gateway", "--model",
             ckpt, "--replicas", "2", "--port", "0", "--dtype", "fp32",
             "--device", DEVICE],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env={**os.environ, "PYTHONPATH": ROOT})
        line = proc.stdout.readline()
        check("gateway at http://" in line,
              f"15b: the gateway did not boot: {line!r}")
        url = line.split(" at ")[1].split()[0]
        docs, wall = gateway_pass(url, specs, "c")
        for i, d in enumerate(docs):
            got = Streamed(d, specs[i][0])
            check(got.tokens == want[i].tokens
                  and got.finish_reason == want[i].finish_reason,
                  f"15b request {i}: the gateway's stream differs from one "
                  "fp32 Server's")
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=300)
        check(proc.returncode == 0 and "drained clean" in err,
              f"15b: exit code {proc.returncode} after SIGTERM: "
              f"{err[-800:]}")
        print(f"phase 15b cli.gateway --replicas 2 --dtype fp32 over a "
              f"2-layer full-width checkpoint: {len(docs)} HTTP responses "
              f"in {wall:.2f} s token-exact to one fp32 Server; SIGTERM "
              f"drained, exit 0 [{ctx['card']}]")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(ckpt, ignore_errors=True)


# ------------------------------------------------------------- sampled

SAMPLED_TEMP, SAMPLED_TOP_K, GEN_TOP_P = 0.8, 50, 0.9


def sampled_knobs(i: int) -> dict:
    """16a's knobs for phase 4's request ``i``: every second request
    samples (temperature 0.8, top-k 50 on half of those and none on the
    others), each with its own seed; the rest are greedy."""
    if i % 2 == 0:
        return {}
    return dict(temperature=SAMPLED_TEMP,
                top_k=SAMPLED_TOP_K if i % 4 == 1 else 0, seed=SEED + i)


def sampled_parting(model, prompt, a: list, b: list, knobs: dict,
                    what: str):
    """Two streams of one sampled request held to the near-tie rule of a
    draw: at their first parting ``j`` the plain forward over the common
    prefix, scaled and cut as the request's sampler does, plus the
    Gumbel variates of its ``j``-th subkey (``PRNGKey(seed)`` split once
    a token), must put both tokens within ``NEAR_TIE`` x the row's
    largest |logit| over the temperature. None when the streams are
    equal; else (index, gap, tolerance)."""
    import torch

    from tony_tpu_torch.ops import sampling

    j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if j is None:
        check(len(a) == len(b), f"{what}: {len(a)} tokens against "
              f"{len(b)}")
        return None
    seq = torch.tensor([list(prompt) + list(a[:j])], device=DEVICE)
    with torch.no_grad():
        hidden = model(seq, return_hidden=True)
        logits = model.logits(hidden[0, -1:])
    key = sampling.key_tensor(knobs["seed"], DEVICE)
    for _ in range(j):
        key = sampling.split(key)[0]
    temp = knobs["temperature"]
    cut = sampling._rank_cut(
        logits / temp, torch.tensor([knobs["top_k"]], device=DEVICE))[0]
    z = cut + sampling.gumbel(sampling.split(key)[1],
                              (logits.shape[-1],))
    gap = abs(float(z[a[j]] - z[b[j]]))
    tol = NEAR_TIE * float(logits.abs().max()) / temp
    check(gap <= tol, f"{what}: the sampled streams part at token {j} "
          f"({a[j]} against {b[j]}), draw gap {gap:.4g} under the plain "
          f"forward > {tol:.4g}")
    return j, gap, tol


def phase_sampled(ctx) -> None:
    """16: sampled serving and sampled ``generate`` through replayed
    graphs (see the module docstring)."""
    import numpy as np
    import torch

    from tony_tpu_torch.models.transformer import Transformer
    from tony_tpu_torch.serve import Request

    cfg = qwen_config(dtype=torch.bfloat16)
    model = Transformer(cfg, device=DEVICE).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    specs = ctx["serve4"]["specs"]
    s4 = ctx["serve4"]

    def reqs():
        return [Request(list(p), n, id=i, **sampled_knobs(i))
                for i, (p, n) in enumerate(specs)]

    srv = serve_server(model)
    runs = {}
    for how in ("cold", "warm"):
        base = srv.counters()
        r = reqs()
        run = serve_timed(srv, r)
        c = check_run(srv, r, run, f"16a {how}", base)
        chunks = c["dispatches"] - base.get("dispatches", 0)
        caps = c["graph_decode_captures"] - base.get(
            "graph_decode_captures", 0)
        reps = c["graph_decode_replays"] - base.get(
            "graph_decode_replays", 0)
        check(c["graph_decode_eager"] == 0 and caps + reps == chunks,
              f"16a {how}: {caps} captures + {reps} replays + "
              f"{c['graph_decode_eager']} eager of {chunks} chunks")
        ctx["launches"] += run["launches"]
        gen = sum(len(res.tokens) for res in run["results"].values())
        p50, p99 = percentiles(run["first"][q.id] for q in r)
        cap_s = c["graph_capture_s"] - base.get("graph_capture_s", 0.0)
        runs[how] = run
        print(f"phase 16a sampled serve, phase 4's configuration and 24 "
              f"requests, 12 sampled (temperature {SAMPLED_TEMP}, top-k "
              f"{SAMPLED_TOP_K} on 6, none on 6), {how}: {gen} tokens in "
              f"{run['wall']:.2f} s = {gen / run['wall']:.1f} tok/s "
              f"(phase 4 greedy, cold: {s4['rate']:.1f}); TTFT p50 "
              f"{p50:.3f} s, p99 {p99:.3f} s (phase 4: {s4['ttft'][0]:.3f}"
              f" / {s4['ttft'][1]:.3f} s); {cap_s:.2f} s capturing (phase "
              f"4: {s4['capture_s']:.2f} s); {chunks} chunks: {caps} "
              f"captures + {reps} replays, 0 eager; flash_decode launches "
              f"{run['launches']} [{ctx['card']}]")
    keys = sorted(k for k in srv.graphs.entries if k[0] == "decode")
    print(f"phase 16a chunk keys: {sum(k[-1] == 'sampled' for k in keys)} "
          f"sampled, {sum(k[-1] != 'sampled' for k in keys)} greedy; "
          f"capture cost {capture_text(srv.graphs)} [{ctx['card']}]")
    mixed = runs["cold"]["results"]
    want = s4["results"]
    greedy_ties, sampled_ties = [], []
    for i, (prompt, _) in enumerate(specs):
        if sampled_knobs(i):
            continue
        tie = parting(model, prompt, mixed[i].tokens, want[i].tokens,
                      f"16a greedy request {i} against phase 4")
        if tie is None:
            check(mixed[i].finish_reason == want[i].finish_reason,
                  f"16a request {i}: {mixed[i].finish_reason} against "
                  f"{want[i].finish_reason}")
        else:
            greedy_ties.append((i, *tie))
    warm_equal = sum(runs["warm"]["results"][i].tokens == mixed[i].tokens
                     for i in mixed)
    for i, (prompt, n) in enumerate(specs):
        knobs = sampled_knobs(i)
        if not knobs:
            continue
        alone = serve_timed(srv, [Request(list(prompt), n, id="alone",
                                          **knobs)])["results"]["alone"]
        tie = sampled_parting(model, prompt, mixed[i].tokens,
                              alone.tokens, knobs,
                              f"16a sampled request {i} alone")
        if tie is None:
            check(mixed[i].finish_reason == alone.finish_reason,
                  f"16a sampled request {i}: {mixed[i].finish_reason} "
                  f"mixed against {alone.finish_reason} alone")
        else:
            sampled_ties.append((i, *tie))
    print(f"phase 16a greedy requests against phase 4: "
          f"{ties_text(greedy_ties, 12)}; sampled requests alone against "
          f"in the mix: {ties_text(sampled_ties, 12)}; warm pass equal to "
          f"cold in {warm_equal} of 24 streams [{ctx['card']}]")
    del srv
    torch.cuda.empty_cache()
    sampled_replay_check(ctx, model, np.random.default_rng(SEED + 16))
    sampled_generate(ctx, model, np.random.default_rng(SEED + 17))
    del model
    torch.cuda.empty_cache()


def sampled_replay_check(ctx, model, rng) -> None:
    """16b: a Server with speculation (phase 13a's ``speculate_k``) and 8
    requests of 1500 tokens, 4 greedy over a repeated pattern (they
    draft) and 4 sampled; after their first round, on one saved state
    (pool and keys put back before each run), one sampled chunk and one
    sampled verify round each replayed and eager: tokens, keys and pool
    bytes bit-equal; then each timed (median of 3), a greedy chunk
    replayed on the same state beside the sampled one, and the sampler
    alone on [8, V] logits under torch.profiler."""
    import functools

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tony_tpu_torch.ops import sampling
    from tony_tpu_torch.serve import Request
    from tony_tpu_torch.serve.engine import _decode_chunk, _verify_chunk

    srv = serve_server(model, speculate_k=SPEC_K)
    for i in range(8):
        if i % 2 == 0:
            prompt = np.resize(rng.integers(0, 151643, 6), 1500).tolist()
            knobs = {}
        else:
            prompt = rng.integers(0, 151643, 1500).tolist()
            knobs = dict(temperature=SAMPLED_TEMP, seed=SEED + 100 + i,
                         top_k=SAMPLED_TOP_K if i % 4 == 1 else 0)
        srv.submit(Request(prompt, 64, id=f"s{i}", **knobs))
    srv.step()  # admits all 8 and runs their first round
    check(srv.n_active == 8, f"16b: {srv.n_active} of 8 live")
    s = srv.slots
    rows = (s.temps, s.top_ks, s.keys)
    k, ccols, cflat = srv._prepare_chunk()
    drafts = srv._collect_drafts()
    if drafts is None:  # no draft proposed: the round's layout is the same
        drafts = [np.full(4, s.last_token[i]) if s.temperature[i] == 0
                  else None for i in range(8)]
    window, k_cont, vcols, vflat, _ = srv._prepare_verify(drafts)
    leaves = pool_leaves(srv)
    saved = [leaf.clone() for leaf in leaves]
    saved_keys = s.keys.clone()
    n = s.pool.n_pages

    def restore():
        for leaf, keep in zip(leaves, saved):
            leaf.copy_(keep)
        s.keys.copy_(saved_keys)
        sync()

    calls = {
        "chunk": (("decode", k, ccols, "sampled"),
                  lambda: srv._run_chunk(cflat, k, ccols),
                  lambda: _decode_chunk(
                      srv.model, s.cache,
                      torch.as_tensor(cflat, device=DEVICE), *rows,
                      b=s.batch_size, cols=ccols, n_steps=k,
                      eos_ids=srv.eos_ids).cpu().numpy()),
        "verify round": (("verify", window, k_cont, vcols, "sampled"),
                         lambda: srv._run_verify(vflat, window, k_cont,
                                                 vcols),
                         lambda: _verify_chunk(
                             srv.model, s.cache,
                             torch.as_tensor(vflat, device=DEVICE), *rows,
                             b=s.batch_size, window=window, cols=vcols,
                             n_steps=k_cont,
                             eos_ids=srv.eos_ids).cpu().numpy())}
    ms = {}
    for name, (key, replayed, eager) in calls.items():
        restore()
        if key not in srv.graphs.entries:
            replayed()  # its first call: eager, then captured
            restore()
        want = eager()
        want_pool = [leaf[:n].clone() for leaf in leaves]
        want_keys = s.keys.clone()
        restore()
        before = srv.graphs.calls[key[0], "replays"]
        got = replayed()
        check(srv.graphs.calls[key[0], "replays"] == before + 1,
              f"16b: the sampled {name} was not a replay")
        check((got == want).all(), f"16b: replayed sampled {name} tokens "
              "differ from the eager run's")
        check(torch.equal(s.keys, want_keys), f"16b: replayed sampled "
              f"{name} keys differ from the eager run's")
        check(all(torch.equal(leaf[:n], w)
                  for leaf, w in zip(leaves, want_pool)),
              f"16b: replayed sampled {name} pool bytes differ from the "
              "eager run's")
        check(not (want_keys == saved_keys).all(),
              f"16b: the sampled {name} advanced no key")
        del want_pool
        times = {"eager": [], "replayed": []}
        for _ in range(3):
            for how, run in (("eager", eager), ("replayed", replayed)):
                restore()
                t0 = time.perf_counter()
                run()
                times[how].append(time.perf_counter() - t0)
        ms[name] = {how: statistics.median(t) * 1e3
                    for how, t in times.items()}
    # the greedy variant of the same chunk key, replayed on the same state
    greedy_fn = functools.partial(
        _decode_chunk, srv.model, s.cache, b=s.batch_size, cols=ccols,
        n_steps=k, eos_ids=srv.eos_ids)
    restore()
    srv._dispatch("decode", (k, ccols), cflat, greedy_fn)
    g_times = []
    for _ in range(3):
        restore()
        t0 = time.perf_counter()
        srv._dispatch("decode", (k, ccols), cflat, greedy_fn).cpu()
        g_times.append(time.perf_counter() - t0)
    restore()
    greedy_ms = statistics.median(g_times) * 1e3
    # the sampler alone on one micro-step's logits
    logits = torch.randn(8, model.cfg.vocab_size, device=DEVICE,
                         generator=torch.Generator(device=DEVICE)
                         .manual_seed(SEED)) * 4
    done = torch.zeros(8, dtype=torch.bool, device=DEVICE)
    for _ in range(2):
        sampling.sample_rows(logits, s.keys, s.temps, s.top_ks, done)
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sampling.sample_rows(logits, s.keys, s.temps, s.top_ks, done)
        sync()
    dev_us, ops = device_busy(prof)
    restore()
    del saved
    while not srv.done:
        srv.step()
    c = srv.counters()
    check(c["graph_decode_eager"] == c["graph_verify_eager"] == 0,
          "16b: a chunk or verify round ran eagerly")
    print(f"phase 16b on one saved state, batch 8 (4 sampled), replayed "
          f"and eager: a sampled chunk ({k} micro-steps, {ccols} page "
          f"columns) and a sampled verify round (window {window}, {k_cont} "
          f"continuation steps): tokens, keys and pool bytes bit-equal; "
          f"median of 3: chunk eager {ms['chunk']['eager']:.1f} ms, "
          f"replayed {ms['chunk']['replayed']:.1f} ms (the greedy variant "
          f"replayed {greedy_ms:.1f} ms); verify round eager "
          f"{ms['verify round']['eager']:.1f} ms, replayed "
          f"{ms['verify round']['replayed']:.1f} ms [{ctx['card']}]")
    print(f"phase 16b the sampler a micro-step (sample_rows on [8, "
          f"{model.cfg.vocab_size}] fp32 logits, eager, torch.profiler): "
          f"{dev_us * 1e-3:.3f} ms of device time in {ops} device ops; "
          f"sampled less greedy chunk, replayed, over {k} micro-steps: "
          f"{(ms['chunk']['replayed'] - greedy_ms) / k:.3f} ms "
          f"[{ctx['card']}]")
    ctx["sampled16b"] = {"ms": ms, "greedy_ms": greedy_ms,
                         "sampler_ms": dev_us * 1e-3}


def sampled_generate(ctx, model, rng) -> None:
    """16c: a sampled ``generate`` (temperature 0.8, top-k 50, top-p 0.9;
    batch 8, 512-token prompts, 128 tokens) replayed and eager from the
    same generator state: tokens bit-equal, tok/s beside phase 11's
    greedy."""
    import torch

    from tony_tpu_torch.models.generate import (_generate_eager, _picker,
                                                generate)
    from tony_tpu_torch.ops.sampling import key_from_generator

    prompt = torch.as_tensor(rng.integers(0, 151643, (INT8_BATCH,
                                                      INT8_PROMPT)),
                             device=DEVICE)
    kw = dict(temperature=SAMPLED_TEMP, top_k=SAMPLED_TOP_K, top_p=GEN_TOP_P)

    def gen(seed):
        return torch.Generator(device=DEVICE).manual_seed(seed)

    generate(model, prompt[:, :16], max_new_tokens=2, generator=gen(1),
             **kw)  # captures the sampled step
    before = model.graphs.counters(("generate",))
    sync()
    t0 = time.perf_counter()
    got = generate(model, prompt, max_new_tokens=INT8_NEW,
                   generator=gen(SEED), **kw)
    sync()
    wall_r = time.perf_counter() - t0
    after = model.graphs.counters(("generate",))
    check(after["generate_replays"] - before["generate_replays"]
          == INT8_NEW - 1 and after["generate_eager"] == 0
          and after["generate_captures"] == before["generate_captures"],
          f"16c: generate counters {before} -> {after}: every step must "
          "be a replay")
    sync()
    t0 = time.perf_counter()
    sampler = (key_from_generator(gen(SEED), DEVICE), SAMPLED_TEMP,
               SAMPLED_TOP_K, GEN_TOP_P)
    want = _generate_eager(model, prompt, INT8_NEW, _picker(model, sampler),
                           ())
    sync()
    wall_e = time.perf_counter() - t0
    check(torch.equal(got, want), "16c: replayed sampled generate's tokens "
          "differ from the eager loop's")
    distinct = int(torch.unique(got).numel())
    check(distinct > INT8_NEW, f"16c: only {distinct} distinct tokens")
    tokens = INT8_BATCH * INT8_NEW
    greedy = ctx["int8_generate"]["bf16"]["replayed"]["tok_s"]
    print(f"phase 16c sampled generate (temperature {SAMPLED_TEMP}, top-k "
          f"{SAMPLED_TOP_K}, top-p {GEN_TOP_P}), batch {INT8_BATCH}, "
          f"{INT8_PROMPT}-token prompts, {INT8_NEW} tokens: replayed "
          f"{wall_r:.3f} s = {tokens / wall_r:.1f} tok/s, eager "
          f"{wall_e:.3f} s = {tokens / wall_e:.1f} tok/s, tokens bit-equal "
          f"({distinct} distinct); phase 11 greedy replayed "
          f"{greedy:.1f} tok/s [{ctx['card']}]")
    ctx["sampled16c"] = {"tok_s": tokens / wall_r,
                         "eager_tok_s": tokens / wall_e}


# ------------------------------------------------------------ KV fabric

FABRIC_FLAGS = ("--kv-page-size", "64", "--prefix-cache-mb", "64",
                "--port", "0")
# 17c (bf16): the moved streams' prompt, budget and tokens before a move
MOVE_PROMPT, MOVE_BUDGET, MOVE_AFTER = 512, 768, 64
# 17d: the prefix store under the host tier (about one prompt's entry)
TIER_STORE_MB = 8.0


class Spans:
    """Host wall-clock spans: ``wrap(obj, attr)`` times every call of
    ``obj.attr`` (a class's function or an instance's bound method) under
    a name, ``key(args)`` when given (a call whose key is None is not
    recorded); ``restore()`` puts each back. A
    measurement only: nothing is synchronised that the call does not
    synchronise itself."""

    def __init__(self):
        self.ms: dict = {}
        self._undo: list = []

    def wrap(self, obj, attr: str, name: str = "", key=None) -> None:
        real = getattr(obj, attr)
        own = attr in vars(obj)
        self._undo.append((obj, attr, real if own or isinstance(obj, type)
                           else None))

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return real(*args, **kw)
            finally:
                label = key(args) if key is not None else (name or attr)
                if label is not None:
                    self.ms.setdefault(label, []).append(
                        (time.perf_counter() - t0) * 1e3)

        setattr(obj, attr, timed)

    def restore(self) -> None:
        for obj, attr, real in reversed(self._undo):
            if real is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, real)
        self._undo.clear()

    def text(self) -> str:
        """'name n x p50 ms (sum ms)' for each span, in first-call order."""
        return "; ".join(
            f"{k} {len(v)} x p50 {statistics.median(v):.1f} ms "
            f"(sum {sum(v):.1f})" for k, v in self.ms.items())


def export_checkpoint(model, hf: dict) -> str:
    """``model``'s weights as a checkpoint directory under build/ that
    ``models.hf.load_llama_dir`` reads back to the same model:
    ``config.json`` = ``hf``, ``model.safetensors`` in the Hugging Face
    names, each tensor in its own dtype. The caller removes it."""
    from tony_tpu_torch.models.hf import write_safetensors

    sd = model.state_dict()
    out = {"model.embed_tokens.weight": sd["embedding"],
           "model.norm.weight": sd["ln_f.scale"]}
    if "lm_head" in sd:
        out["lm_head.weight"] = sd["lm_head"]
    names = {"input_layernorm.weight": "ln1.scale",
             "post_attention_layernorm.weight": "ln2.scale",
             "mlp.gate_proj.weight": "mlp.wg.weight",
             "mlp.up_proj.weight": "mlp.wi.weight",
             "mlp.down_proj.weight": "mlp.wo.weight",
             "self_attn.o_proj.weight": "attn.o.weight"}
    for p in "qkv":
        names[f"self_attn.{p}_proj.weight"] = f"attn.{p}.weight"
        names[f"self_attn.{p}_proj.bias"] = f"attn.{p}.bias"
    for i in range(model.cfg.n_layers):
        for dst, src in names.items():
            if f"blocks.{i}.{src}" in sd:
                out[f"model.layers.{i}.{dst}"] = sd[f"blocks.{i}.{src}"]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="smoke_ckpt_",
                            dir=os.path.join(ROOT, "build"))
    with open(os.path.join(ckpt, "config.json"), "w") as fh:
        json.dump(hf, fh)
    write_safetensors(out, os.path.join(ckpt, "model.safetensors"))
    return ckpt


def launch_agents(specs: list) -> list:
    """One ``python -m tony_tpu_torch.cli.replica`` subprocess for each
    argv of ``specs``, all booting at once (``launch_local_agent``):
    [(process, "host:port")]. The kernels are built already (phase 1),
    so the agents load them."""
    from concurrent.futures import ThreadPoolExecutor

    from tony_tpu_torch.gateway.remote import launch_local_agent

    port_dir = tempfile.mkdtemp(prefix="smoke_agents_",
                                dir=os.path.join(ROOT, "build"))
    env = {**os.environ, "PYTHONPATH": ROOT}
    with ThreadPoolExecutor(len(specs)) as ex:
        futs = [ex.submit(launch_local_agent, list(argv),
                          port_file=os.path.join(port_dir, f"a{i}.port"),
                          env=env, boot_timeout_s=300.0)
                for i, argv in enumerate(specs)]
        return [f.result() for f in futs]


def stop_agents(agents: list, part: str) -> None:
    """SIGTERM each agent: it drains and must exit 0."""
    for proc, _ in agents:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
    for proc, addr in agents:
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "killed after 120 s"
        check(rc == 0, f"{part}: agent {addr} exited {rc} after SIGTERM")


def reset_agents(agents: list) -> None:
    """``POST /v1/reset`` to each agent between two gateways: the engine
    resets and the agent forgets the last gateway's tickets, whose ids a
    new gateway's (counting from 0 again, on the same epoch) would
    otherwise meet as duplicates."""
    import urllib.request

    for _, addr in agents:
        req = urllib.request.Request(
            f"http://{addr}/v1/reset", data=json.dumps({"epoch": 0}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            check(r.status == 200, f"agent {addr}: reset {r.status}")


def agent_counters(addr: str) -> dict:
    """The agent engine's counters, read from its ``/healthz``."""
    return http_json(f"http://{addr}", "/healthz")["counters"]


def fabric_gateway(agents: list, **kw):
    """A started gateway of ``RemoteServer`` stubs over ``agents``, with
    leases long enough for cold captures."""
    from tony_tpu_torch.gateway import Gateway, RemoteServer

    stubs = [RemoteServer(addr, heartbeat_interval_s=0.5, lease_misses=240,
                          stall_timeout_s=600.0, boot_timeout_s=300.0)
             for _, addr in agents]
    return Gateway(stubs, max_queue=256, stall_timeout_s=600.0, **kw).start()


def submit_all(gw, reqs: list) -> tuple:
    """``reqs`` (GenRequests) at once through ``gw``: (tickets, results by
    index, wall seconds from a synchronised start to the last result)."""
    sync()
    t0 = time.perf_counter()
    tickets = [gw.submit(r) for r in reqs]
    results = {i: t.result(timeout=900) for i, t in enumerate(tickets)}
    wall = time.perf_counter() - t0
    return tickets, results, wall


def launches_per_agent(before: list, after: list, layers: int,
                       part: str, idle_ok: bool = False) -> list:
    """Each agent's flash-decode launches between two counter reads, held
    to n_layers per single-token micro-step (replays included); an agent
    with no micro-step fails the check unless ``idle_ok``."""
    out = []
    for i, (b, a) in enumerate(zip(before, after)):
        n = a["flash_decode_launches"] - b.get("flash_decode_launches", 0)
        micro = (a["decode_steps"] - b.get("decode_steps", 0)) \
            - (a["spec_window_steps"] - b.get("spec_window_steps", 0))
        check(n == layers * micro and (micro > 0 or idle_ok),
              f"{part} agent {i}: flash_decode launched {n} times, "
              f"expected {layers} x {micro} micro-steps")
        out.append(n)
    return out


def phase_fabric(ctx) -> None:
    """17: remote replicas and the KV fabric (see the module
    docstring)."""
    import gc

    import numpy as np
    import torch

    from tony_tpu_torch.gateway import GenRequest
    from tony_tpu_torch.models.transformer import Transformer
    from tony_tpu_torch.serve.tier import payload_nbytes

    # what the earlier phases hold goes back before four agent processes
    # take the card
    gc.collect()
    torch.cuda.empty_cache()
    cfg = qwen_config(dtype=torch.bfloat16)
    model = Transformer(cfg, device=DEVICE).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    hf = dict(QWEN25_15B, max_position_embeddings=SERVE_MAX_LEN,
              eos_token_id=list(SERVE_EOS))
    bf16_ckpt = export_checkpoint(model, hf)
    fp32_ckpt = write_checkpoint()
    dev = ["--device", DEVICE]
    t0 = time.perf_counter()
    agents = launch_agents(
        [["--model", bf16_ckpt, "--dtype", "bf16", "--serve-batch", "8",
          "--chunk-steps", "8", *FABRIC_FLAGS, *dev]] * 2
        + [["--model", fp32_ckpt, "--dtype", "fp32", "--serve-batch", "4",
            "--chunk-steps", "1", *FABRIC_FLAGS, *dev]] * 2)
    boot_s = time.perf_counter() - t0
    bf16_agents, fp32_agents = agents[:2], agents[2:]
    s4 = ctx["serve4"]
    specs = s4["specs"]
    want = s4["results"]
    layers = cfg.n_layers
    launched = 0
    try:
        # ---- 17a: two agents, phase 4's traffic, cold
        gw = fabric_gateway(bf16_agents)
        try:
            before = [agent_counters(a) for _, a in bf16_agents]
            tickets, res, wall = submit_all(
                gw, [GenRequest(list(p), n, id=f"a{i}")
                     for i, (p, n) in enumerate(specs)])
            after = [agent_counters(a) for _, a in bf16_agents]
            n_fd = launches_per_agent(before, after, layers, "17a")
            launched += sum(n_fd)
            ties = near_ties(model, specs, res, want, "17a")
            gen = sum(len(r.tokens) for r in res.values())
            p50, p99 = percentiles(t.metrics["ttft_ms"] / 1e3
                                   for t in tickets)
            print(f"phase 17a two cli.replica agents (bf16, batch 8, "
                  f"flash-decode) behind a Gateway of RemoteServers, cold, "
                  f"phase 4's 24 requests: {gen} tokens in {wall:.2f} s = "
                  f"{gen / wall:.1f} tok/s (phase 4: {s4['rate']:.1f}); "
                  f"TTFT p50 {p50:.3f} s, p99 {p99:.3f} s; "
                  f"{ties_text(ties, len(specs))}; the four agents booted "
                  f"in {boot_s:.1f} s [{ctx['card']}]")
            print("phase 17a by agent: " + "; ".join(
                f"agent {i}: {a['prefills']} prefills, "
                f"{a['graph_capture_s']:.2f} s capturing, peak "
                f"{a['cuda_peak_bytes'] / 2**30:.2f} GiB, flash_decode "
                f"{n_fd[i]} = {layers} x "
                f"{a['decode_steps'] - a['spec_window_steps']}"
                for i, a in enumerate(after)) + f" [{ctx['card']}]")

            # ---- 17c (bf16): a long greedy and a sampled stream moved
            rng = np.random.default_rng(SEED + 17)
            long_p = rng.integers(0, 151643, MOVE_PROMPT).tolist()
            knobs = [{}, dict(temperature=SAMPLED_TEMP,
                              top_k=SAMPLED_TOP_K, seed=SEED + 17)]
            ctl = [gw.submit(GenRequest(list(long_p), MOVE_BUDGET,
                                        id=f"m{j}", **k)).result(timeout=900)
                   for j, k in enumerate(knobs)]
            spans = fabric_spans(gw)
            try:
                moved = migrate_streams(gw, bf16_agents, long_p,
                                        MOVE_BUDGET, knobs, "17c bf16",
                                        after=MOVE_AFTER)
            finally:
                spans.restore()
            tie = parting(model, long_p, moved["tokens"][0],
                          ctl[0].tokens, "17c bf16 greedy")
            stie = sampled_parting(model, long_p, moved["tokens"][1],
                                   ctl[1].tokens, knobs[1],
                                   "17c bf16 sampled")
            launched += moved["launches"]
            print(f"phase 17c live migration between the two bf16 agents "
                  f"(Gateway.migrate_session after {MOVE_AFTER} tokens, "
                  f"{MOVE_PROMPT}-token prompt, budget {MOVE_BUDGET}): "
                  f"greedy and sampled (temperature "
                  f"{SAMPLED_TEMP}, top-k {SAMPLED_TOP_K}) streams "
                  + ("equal" if tie is None and stie is None else
                     f"near-tie equal (greedy {tie}, sampled {stie})")
                  + " to the unmigrated ones; freeze to resume "
                  + ", ".join(f"{x:.1f}" for x in moved["resume_ms"])
                  + f" ms, {moved['pages']} pages and {moved['bytes']} B "
                  f"moved over the wire [{ctx['card']}]")
            print(f"phase 17c host spans in the gateway process over the "
                  f"two moves: {spans.text()} [{ctx['card']}]")
        finally:
            gw.drain(timeout=600)

        # ---- 17b: the role split over the same two agents (warm)
        reset_agents(bf16_agents)
        gw = fabric_gateway(bf16_agents, roles=["prefill", "decode"])
        try:
            before = [agent_counters(a) for _, a in bf16_agents]
            tickets, res, wall = submit_all(
                gw, [GenRequest(list(p), n, id=f"b{i}")
                     for i, (p, n) in enumerate(specs)])
            after = [agent_counters(a) for _, a in bf16_agents]
            n_fd = launches_per_agent(before, after, layers, "17b",
                                      idle_ok=True)
            check(n_fd[0] == 0 and n_fd[1] > 0,
                  f"17b: flash_decode launched {n_fd[0]} times on the "
                  f"prefill agent, {n_fd[1]} on the decode agent")
            launched += n_fd[1]
            ties = near_ties(model, specs, res, want, "17b")
            snap = gw.snapshot()
            check(snap["routing"]["handoffs"] == len(specs),
                  f"17b: {snap['routing']['handoffs']} handoffs of "
                  f"{len(specs)}")
            check(after[1]["prefills"] == before[1]["prefills"],
                  "17b: the decode agent prefilled")
            wire = [(payload_nbytes(t.handoff["pages"]),
                     -(-len(p) // 64)) for t, (p, _) in zip(tickets, specs)]
            gen = sum(len(r.tokens) for r in res.values())
            p50, p99 = percentiles(t.metrics["ttft_ms"] / 1e3
                                   for t in tickets)
            print(f"phase 17b roles prefill=1, decode=1 over the two bf16 "
                  f"agents (warm: 17a's graphs and prefix stores): "
                  f"{snap['routing']['handoffs']} handoffs; {gen} tokens "
                  f"in {wall:.2f} s = {gen / wall:.1f} tok/s; TTFT p50 "
                  f"{p50:.3f} s, p99 {p99:.3f} s; "
                  f"{ties_text(ties, len(specs))} [{ctx['card']}]")
            print("phase 17b pages and bytes on the wire by request "
                  "(payload bucket's bytes, real pages): "
                  + ", ".join(f"{i}: {b} B / {n} p"
                              for i, (b, n) in enumerate(wire))
                  + f"; {sum(b for b, _ in wire) / sum(n for _, n in wire):.0f}"
                  f" B a real page (28 layers x 2 x 2 KV heads x 128 x 2 B"
                  f" x 64 tokens = {28 * 2 * 2 * 128 * 2 * 64} B) "
                  f"[{ctx['card']}]")
        finally:
            gw.drain(timeout=600)

        # ---- 17b/17c fp32 on phase 5's 2-layer checkpoint: exact
        launched += fabric_fp32(ctx, fp32_ckpt, fp32_agents)
    finally:
        stop_agents(agents, "17")
        shutil.rmtree(bf16_ckpt, ignore_errors=True)

    # ---- 17d: the host tier, in process; then 17c's move in parts
    host_tier_part(ctx, model)
    move_parts(ctx, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # ---- 17e: the CLI
    try:
        fabric_cli(ctx, fp32_ckpt)
    finally:
        shutil.rmtree(fp32_ckpt, ignore_errors=True)
    ctx["launches"] += launched


def fabric_spans(gw) -> Spans:
    """Spans over a migration as the gateway process runs it: the stub's
    two agent calls (``POST /v1/migrate_out``: the source agent's
    extract, encode and reply; ``POST /v1/migrate_in``: the request to
    the adopter and its reply), the codec steps the stub runs itself,
    and ``Gateway.migrate_session`` whole."""
    import tony_tpu_torch.serve.migrate as migrate_mod
    from tony_tpu_torch.gateway.remote import AgentTransport

    spans = Spans()
    spans.wrap(AgentTransport, "call",
               key=lambda a: f"POST {a[2]}" if "/v1/migrate" in a[2]
               else None)
    for f in ("snapshot_from_doc", "snapshot_to_doc", "delta_trim_doc"):
        spans.wrap(migrate_mod, f)
    spans.wrap(gw, "migrate_session")
    return spans


def move_parts(ctx, model) -> None:
    """17c's move taken apart, at its size (bf16, the same prompt, frozen
    after the same number of tokens), with the source agent in this
    process: a ``ReplicaAgent`` stepping on its own thread behind
    ``AgentHTTP``, asked for the session by ``POST /v1/migrate_out`` as
    the stub asks, once with the source otherwise idle and once while
    it steps a second stream. Spans: the call, the agent's
    ``migrate_out``, ``extract_session`` (gather and stream synchronize),
    ``snapshot_to_doc`` (the copy to the host and base64), the reply
    (``json.dumps`` and the socket write); then the adopter's admission
    (``decode_payload`` and the scatter inside it)."""
    import numpy as np

    import tony_tpu_torch.serve.engine as engine_mod
    import tony_tpu_torch.serve.migrate as migrate_mod
    from tony_tpu_torch.gateway.remote import AgentTransport
    from tony_tpu_torch.serve import Request
    from tony_tpu_torch.serve.agent import AgentHandler, AgentHTTP, \
        ReplicaAgent

    rng = np.random.default_rng(SEED + 17)
    long_p = rng.integers(0, 151643, MOVE_PROMPT).tolist()
    other_p = rng.integers(0, 151643, MOVE_PROMPT).tolist()
    spans = Spans()
    body = {}
    for load in ("idle", "busy"):
        src = serve_server(model)
        http = AgentHTTP(ReplicaAgent(src)).start()
        try:
            http.agent.submit({"prompt": long_p, "id": "m", "epoch": 0,
                               "max_new_tokens": MOVE_BUDGET})
            if load == "busy":
                http.agent.submit({"prompt": other_p, "id": "o",
                                   "epoch": 0,
                                   "max_new_tokens": MOVE_BUDGET})
            deadline = time.monotonic() + 300
            while len(src.live_progress().get("m", ())) < MOVE_AFTER \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
            spans.wrap(AgentTransport, "call", f"POST /v1/migrate_out "
                       f"({load})")
            spans.wrap(http.agent, "migrate_out", f"agent migrate_out "
                       f"({load})")
            spans.wrap(src, "extract_session", f"extract_session ({load})")
            spans.wrap(migrate_mod, "snapshot_to_doc",
                       f"snapshot_to_doc ({load})")
            spans.wrap(AgentHandler, "_send", f"reply: json.dumps and "
                       f"write ({load})")
            try:
                out = AgentTransport(http.address, read_timeout_s=120.0
                                     ).call("POST", "/v1/migrate_out",
                                            {"id": "m", "epoch": 0})
            finally:
                spans.restore()
            check(out.get("found"), f"17c parts ({load}): nothing frozen")
            body[load] = out["snapshot"]
        finally:
            http.stop()
            del src
    dst = serve_server(model)
    spans.wrap(engine_mod, "decode_payload")
    spans.wrap(dst, "_scatter")
    spans.wrap(dst, "_admit_migrate")
    try:
        dst.submit(Request(list(long_p), MOVE_BUDGET, id="m",
                           migrate=body["busy"]))
        dst.step()
        sync()
    finally:
        spans.restore()
    check(dst.counters()["migrations_in"] == 1, "17c parts: no adoption")
    n_tok = body["busy"]["n_tokens"]
    print(f"phase 17c parts, the source agent in this process ({n_tok} "
          f"tokens, {-(-n_tok // 64)} pages, a "
          f"{len(json.dumps(body['busy']))} B snapshot doc): "
          f"{spans.text()} [{ctx['card']}]")
    del dst


def migrate_streams(gw, agents, prompt, budget, knobs, part,
                    after: int = 64) -> dict:
    """One stream for each of ``knobs``, each moved mid-decode (after
    ``after`` emitted tokens) to the other agent by
    ``Gateway.migrate_session``:
    the streams' tokens, each move's freeze-to-resume ms (the adopter's
    counter), the pages and bytes the adopters took over the wire, and
    the agents' flash-decode launches in the run."""
    from tony_tpu_torch.gateway import GenRequest

    before = [agent_counters(a) for _, a in agents]
    tickets = [gw.submit(GenRequest(list(prompt), budget, id=f"{part}{j}",
                                    **k)) for j, k in enumerate(knobs)]
    for t in tickets:
        deadline = time.monotonic() + 600
        while t._n_emitted < after and time.monotonic() < deadline:
            time.sleep(0.005)
        check(t._n_emitted >= after, f"{part}: the stream never reached "
              f"{after} tokens")
        src = t.replica
        check(gw.migrate_session(t.request.id), f"{part}: the move of "
              f"{t.request.id} failed")
        check(t.replica != src, f"{part}: the stream did not move")
    results = [t.result(timeout=900) for t in tickets]
    after = [agent_counters(a) for _, a in agents]
    d = {k: sum(a[k] - b.get(k, 0) for a, b in zip(after, before))
         for k in ("migrations_in", "migrations_out", "migrate_pages_moved",
                   "migrate_bytes_wire", "migrate_freeze_resume_ms",
                   "flash_decode_launches")}
    check(d["migrations_in"] == d["migrations_out"] == len(knobs),
          f"{part}: {d['migrations_out']} out, {d['migrations_in']} in")
    for t, r in zip(tickets, results):
        check(len(r.tokens) == budget or r.finish_reason == "eos",
              f"{part}: {t.request.id} ended {r.finish_reason} after "
              f"{len(r.tokens)}")
    return {"tokens": [r.tokens for r in results],
            "resume_ms": [d["migrate_freeze_resume_ms"] / len(knobs)],
            "pages": d["migrate_pages_moved"] // 2,
            "bytes": d["migrate_bytes_wire"],
            "launches": d["flash_decode_launches"]}


def fabric_fp32(ctx, ckpt: str, agents: list) -> int:
    """17b and 17c in fp32 over phase 5's 2-layer full-width checkpoint:
    the role split's streams and the migrated streams equal one
    ``Server``'s and the unmigrated ones, token for token. Requests go
    one at a time on both sides, so each decode step sees the same live
    extent (page columns, and with them flash-decode's KV splits) in
    the fleet as in the reference. Returns the agents' flash-decode
    launches."""
    import numpy as np

    from tony_tpu_torch.gateway import GenRequest
    from tony_tpu_torch.models.hf import load_llama_dir
    from tony_tpu_torch.serve import Request, Server

    rng = np.random.default_rng(SEED + 2)
    specs = [(rng.integers(0, 151643, n).tolist(), m)
             for n, m in ((40, 12), (300, 20), (5, 1), (900, 8))]
    # 200 + 48 positions stay inside one 4-page column bucket
    long_p = rng.integers(0, 151643, 200).tolist()
    knobs = [{}, dict(temperature=SAMPLED_TEMP, top_k=SAMPLED_TOP_K,
                      seed=SEED + 5)]
    model, _ = load_llama_dir(ckpt, device=DEVICE, decode_attention="flash")
    srv = Server(model, batch_size=4, chunk_steps=1, kv_page_size=64,
                 eos_id=QWEN25_15B["eos_token_id"], prefix_cache_mb=64.0,
                 device=DEVICE)
    want = [list(srv.run([Request(list(p), n, id=i)]))[0]
            for i, (p, n) in enumerate(specs)]
    ctl = [list(srv.run([Request(list(long_p), 48, id=f"c{j}", **k)]))[0]
           for j, k in enumerate(knobs)]
    del srv, model
    before = [agent_counters(a) for _, a in agents]
    gw = fabric_gateway(agents, roles=["prefill", "decode"])
    try:
        for i, (p, n) in enumerate(specs):
            got = gw.submit(GenRequest(list(p), n, id=f"f{i}")).result(
                timeout=900)
            check(got.tokens == want[i].tokens
                  and got.finish_reason == want[i].finish_reason,
                  f"17b fp32 request {i}: the role split's stream differs "
                  "from one Server's")
        handoffs = gw.snapshot()["routing"]["handoffs"]
    finally:
        gw.drain(timeout=600)
    reset_agents(agents)
    gw = fabric_gateway(agents)
    moves = []
    try:
        for j, k in enumerate(knobs):
            moved = migrate_streams(gw, agents, long_p, 48, [k],
                                    f"17c fp32 {j}", after=16)
            check(moved["tokens"][0] == ctl[j].tokens,
                  f"17c fp32 stream {j}: the migrated stream differs from "
                  "the unmigrated one")
            moves.append(moved)
    finally:
        gw.drain(timeout=600)
    after = [agent_counters(a) for _, a in agents]
    print(f"phase 17b/c fp32 over the 2-layer full-width checkpoint "
          f"(flash-decode): roles prefill=1, decode=1, {handoffs} handoffs,"
          f" {len(specs)} streams token-exact to one Server; a greedy and a"
          f" sampled stream each migrated after 16 tokens, token-exact to "
          f"the unmigrated ones, freeze to resume "
          + ", ".join(f"{m['resume_ms'][0]:.1f}" for m in moves)
          + " ms, " + ", ".join(f"{m['pages']} pages / {m['bytes']} B"
                                for m in moves)
          + f" over the wire [{ctx['card']}]")
    return sum(a["flash_decode_launches"] - b["flash_decode_launches"]
               for a, b in zip(after, before))


def host_tier_part(ctx, model) -> None:
    """17d: one in-process Server with an 8 MB prefix store (about one
    prompt's entry) and a 512 MB host tier: six distinct 192-token
    prompts evict each other from the store into the tier, then each
    comes back extended by 64 tokens, so the tier holds a longer prefix
    of it than the store and pages it back in, each paged-in page
    bit-equal to the spilled one. Streams near-tie equal to the run
    without the tier, which re-prefills; the second round's TTFT beside
    it."""
    import numpy as np
    import torch

    import tony_tpu_torch.serve.tier as tier_mod
    from tony_tpu_torch.serve import Request
    from tony_tpu_torch.serve.slots import gather_pages, pool_leaf_keys
    from tony_tpu_torch.serve.tier import payload_pages

    rng = np.random.default_rng(SEED + 4)
    first = [rng.integers(0, 151643, 192).tolist() for _ in range(6)]
    second = [p + rng.integers(0, 151643, 64).tolist() for p in first]
    paged_in = []  # (device pages as paged in, the host entry's row)
    spans = Spans()

    def run(kv_host_mb: float):
        srv = serve_server(model, prefix_cache_mb=TIER_STORE_MB,
                           kv_host_mb=kv_host_mb, prefix_donate=False)
        if kv_host_mb:
            spans.wrap(srv, "_maybe_page_in", "page-in")
            real = srv._maybe_page_in

            def page_in(p, off, entry):
                ins = srv.host_tier.page_ins
                out = real(p, off, entry)
                _, dev_entry = out
                _, host = srv.host_tier.store.acquire(p)
                if host is not None:
                    srv.host_tier.store.release(host)
                if srv.host_tier.page_ins > ins and dev_entry is not None \
                        and host is not None:
                    # a copy of the pages on the device now; the bytes
                    # are held to the host entry after the timed run
                    n = payload_pages(host.row)
                    paged_in.append((gather_pages(
                        srv.slots.cache, torch.tensor(
                            dev_entry.pages[:n], device=DEVICE)), host.row))
                return out

            srv._maybe_page_in = page_in
            spans.wrap(srv.host_tier, "acquire", "page-in tier.acquire "
                       "(waits for the spills in flight)")
            spans.wrap(srv, "_scatter", "page-in scatter")
            spans.wrap(srv.prefix, "on_evict", "spill (gather, queued)")
            spans.wrap(tier_mod, "pages_to_host",
                       "spill copy to the host (its own thread)")
        tag = "with the tier" if kv_host_mb else "without"
        spans.wrap(srv, "_admit_paged", f"admission ({tag})")
        spans.wrap(srv, "_run_chunk", f"decode chunk ({tag})")
        ttft, results = [], {}
        try:
            for rnd, prompts in enumerate((first, second)):
                c0 = srv.counters()
                for i, p in enumerate(prompts):
                    run_i = serve_timed(srv, [Request(list(p), 16, id=i)])
                    if rnd == 1:
                        results[i] = run_i["results"][i]
                        ttft.append(run_i["first"][i])
        finally:
            spans.restore()
        c = srv.counters()
        # the second round's graph work: first calls (captures), replays
        graphs = {k: c[k] - c0.get(k, 0) for k in c
                  if k.startswith("graph_") and isinstance(c[k], int)
                  and c[k] != c0.get(k, 0)}
        return c, ttft, results, graphs

    c_off, ttft_off, res_off, g_off = run(0.0)
    c_on, ttft_on, res_on, g_on = run(512.0)
    check(c_on["kv_host_spills"] > 0 and c_on["kv_host_page_ins"] > 0,
          f"17d: {c_on['kv_host_spills']} spills, "
          f"{c_on['kv_host_page_ins']} page-ins")
    check(len(paged_in) == c_on["kv_host_page_ins"],
          f"17d: {len(paged_in)} of {c_on['kv_host_page_ins']} paged-in "
          "entries held to their spilled bytes")
    for got, row in paged_in:
        for key, name in pool_leaf_keys(row):
            check(torch.equal(got[key][name].cpu().view(torch.uint8),
                              row[key][name].view(torch.uint8)),
                  f"17d: paged-in page {key}.{name} differs from the "
                  "spilled one")
    ties = near_ties(model, [(p, 16) for p in second], res_on, res_off,
                     "17d")
    print(f"phase 17d host tier (a {TIER_STORE_MB:g} MB prefix store, 512 "
          f"MB on the host; 6 distinct 192-token prompts, then each "
          f"extended by 64 tokens): {c_on['kv_host_spills']} spills, "
          f"{c_on['kv_host_page_ins']} page-ins "
          f"({c_on['kv_host_page_in_bytes']} B), prefix hits "
          f"{c_on['prefix_hits']} ({c_on['prefix_hit_tokens']} tokens) "
          f"against {c_off['prefix_hits']} without the tier; "
          f"{len(paged_in)} paged-in entries "
          f"({sum(payload_pages(r) for _, r in paged_in)} pages) "
          f"bit-equal to the spilled pages; second round TTFT p50 "
          f"{percentiles(ttft_on)[0] * 1e3:.1f} ms with the tier, "
          f"{percentiles(ttft_off)[0] * 1e3:.1f} ms without; "
          f"{ties_text(ties, len(second))} [{ctx['card']}]")
    print(f"phase 17d host spans (host walls: device work a span queues is "
          f"waited for by the next one that reads a result): "
          f"{spans.text()}; second round's graph counters: with the tier "
          f"{g_on}, without {g_off} [{ctx['card']}]")


def group_pids(pgid: int) -> list:
    """Pids of the live processes in process group ``pgid`` (a group
    this script started with ``start_new_session``; zombies left out)."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                # "pid (comm) state ppid pgrp ...": comm may hold spaces
                state, _, pgrp = f.read().rsplit(")", 1)[1].split()[:3]
        except (OSError, ValueError, IndexError):
            continue
        if int(pgrp) == pgid and state != "Z":
            out.append(int(pid))
    return out


def fabric_cli(ctx, ckpt: str) -> None:
    """17e: ``cli.gateway --remote-replica --replicas 2 --dtype fp32`` over
    phase 5's checkpoint, against one fp32 Server with flash-decode (what
    the agents run on the card); the agents' flash-decode launches are
    read from them. The gateway runs in a session of its own, so its
    process group holds it and the agents it launches, and nothing else:
    SIGTERM drains it to exit 0 with no process of that group left."""
    import numpy as np

    from tony_tpu_torch.models.hf import load_llama_dir
    from tony_tpu_torch.serve import Request, Server

    rng = np.random.default_rng(SEED + 2)
    specs = [(rng.integers(0, 151643, n).tolist(), m)
             for n, m in ((40, 12), (300, 20), (5, 1), (900, 8))]
    model, _ = load_llama_dir(ckpt, device=DEVICE, decode_attention="flash")
    layers = model.cfg.n_layers
    srv = Server(model, batch_size=4, chunk_steps=1,
                 eos_id=QWEN25_15B["eos_token_id"], prefix_cache_mb=64.0,
                 device=DEVICE)
    want = {r.id: r for r in srv.run(
        [Request(list(p), n, id=i) for i, (p, n) in enumerate(specs)])}
    del srv, model
    proc = subprocess.Popen(
        [sys.executable, "-m", "tony_tpu_torch.cli.gateway", "--model",
         ckpt, "--remote-replica", "--replicas", "2", "--port", "0",
         "--dtype", "fp32", "--device", DEVICE],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": ROOT},
        start_new_session=True)
    try:
        # the launched agents share the gateway's stdout: their boot
        # lines ("... replica agent <id> at http://host:port") come first
        line, addrs = "", []
        for _ in range(8):
            line = proc.stdout.readline()
            if "replica agent" in line and " at http://" in line:
                addrs.append(line.split(" at http://")[1].split()[0])
            if "gateway at http://" in line or not line:
                break
        check("gateway at http://" in line and "remote agents" in line,
              f"17e: the gateway did not boot: {line!r}")
        url = line.split(" at ")[1].split()[0]
        members = group_pids(proc.pid)
        check(len(addrs) == 2 and len(members) == 3,
              f"17e: {len(addrs)} agents booted, {len(members)} processes "
              "in the gateway's group")
        before = [agent_counters(a) for a in addrs]
        docs, wall = gateway_pass(url, specs, "e")
        after = [agent_counters(a) for a in addrs]
        n_fd = launches_per_agent(before, after, layers, "17e",
                                  idle_ok=True)
        check(sum(n_fd) > 0, "17e: the agents launched no flash_decode")
        for i, d in enumerate(docs):
            got = Streamed(d, specs[i][0])
            check(got.tokens == want[i].tokens
                  and got.finish_reason == want[i].finish_reason,
                  f"17e request {i}: the gateway's stream differs from one "
                  "fp32 Server's")
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=300)
        check(proc.returncode == 0 and "drained clean" in err,
              f"17e: exit code {proc.returncode} after SIGTERM: "
              f"{err[-800:]}")
        deadline = time.monotonic() + 10
        while group_pids(proc.pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        left = group_pids(proc.pid)
        check(not left, f"17e: processes {left} outlived the gateway")
        print(f"phase 17e cli.gateway --remote-replica --replicas 2 --dtype "
              f"fp32 over the 2-layer full-width checkpoint: 2 agent "
              f"processes, {len(docs)} HTTP responses in {wall:.2f} s "
              f"token-exact to one fp32 Server; flash_decode launched "
              f"{' + '.join(map(str, n_fd))} times in the agents; SIGTERM "
              f"drained, exit 0, no agent left [{ctx['card']}]")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def job_tree(root: int) -> dict:
    """{pid: command line} of ``root`` and its live descendants, from
    /proc (the client spawns the coordinator, the coordinator the agents,
    the agents the payloads, each in a session of its own, so a process
    group does not hold them)."""
    parents, cmds = {}, {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(
                    errors="replace").strip()
        except (OSError, ValueError, IndexError):
            continue
        if state != "Z":
            parents[int(pid)], cmds[int(pid)] = int(ppid), cmd
    tree, grew = {root}, True
    while grew:
        new = {p for p, pp in parents.items() if pp in tree} - tree
        tree |= new
        grew = bool(new)
    return {p: cmds[p] for p in tree if p in cmds}


def holds_card(pid: int) -> bool:
    """Whether ``pid`` has a GPU device file open: a process with a CUDA
    context does (nvidia-smi's compute-apps list cannot name it on this
    machine: it reports every process as pid 1)."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        with contextlib.suppress(OSError):
            if os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia"):
                return True
    return False


def job_role(cmd: str) -> str:
    """The role of a job process by its command line. ``smi`` is the
    agent's ``nvidia-smi`` query, which opens the card's control device
    for its reading."""
    for mark, role in (("tony_tpu_torch.cli.local", "client"),
                       ("tony_tpu_torch.coordinator", "coordinator"),
                       ("tony_tpu_torch.agent", "agent")):
        if mark in cmd:
            return role
    if os.path.basename(cmd.split(" ", 1)[0]) == "nvidia-smi":
        return "smi"
    return "shell" if cmd.startswith("bash ") else "payload"


def compute_apps() -> list:
    """``nvidia-smi --query-compute-apps=pid,used_memory`` rows."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


class JobWatch:
    """Samples a job's process tree every 0.25 s while it runs: each
    process's role and whether it holds the card, and (while the payload
    holds the card) the card's compute processes."""

    def __init__(self, proc):
        self.proc = proc
        self.cmds: dict = {}
        self.card: dict = {}  # role -> samples that held the card
        self.card_pids: dict = {}  # pid -> samples that held the card
        self.apps: list = []
        self.samples = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(0.25) and self.proc.poll() is None:
            tree = job_tree(self.proc.pid)
            self.cmds.update(tree)
            self.samples += 1
            pids = [p for p in tree if holds_card(p)]
            held = {job_role(tree[p]) for p in pids}
            for role in held:
                self.card[role] = self.card.get(role, 0) + 1
            for p in pids:
                self.card_pids[p] = self.card_pids.get(p, 0) + 1
            if "payload" in held and len(self.apps) < 4:
                self.apps.append(compute_apps())

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


def run_job(ctx, tag: str, root: str, task: list, *confs,
            command: str | None = None) -> dict:
    """``python -m tony_tpu_torch.cli.local --root root`` running
    ``lm_pretrain.py`` over ``QWEN25_15B`` with ``task`` (or the worker
    ``command``) on one worker holding one GPU, watched by ``JobWatch``:
    its exit code, wall, job dir, history, watch and output."""
    from tony_tpu_torch.events import history

    argv = [sys.executable, "-m", "tony_tpu_torch.cli.local", "--root",
            root, "--device", DEVICE, "--conf", "tony.worker.instances=1",
            "--conf", "tony.worker.chips=1"]
    if command is None:
        hf = os.path.join(root, "config.json")
        with open(hf, "w") as f:
            json.dump(QWEN25_15B, f)
        argv += ["--executes", os.path.join(
            ROOT, "tony_tpu_torch", "examples", "lm_pretrain.py"),
            "--task_params", " ".join(
                ["--config-json", hf, "--device", DEVICE, *task])]
    else:
        argv += ["--conf", f"tony.worker.command={command}"]
    for c in confs:
        argv += ["--conf", c]
    t0 = time.time()
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "PYTHONPATH": ROOT},
                            start_new_session=True)
    watch = JobWatch(proc)
    try:
        out, _ = proc.communicate(timeout=900)
    finally:
        watch.stop()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.time() - t0
    jobs = glob.glob(os.path.join(root, "staging", "application_*"))
    check(len(jobs) == 1, f"{tag}: {len(jobs)} job dirs under {root}")
    found = history.list_jobs(os.path.join(root, "history"))
    return {"rc": proc.returncode, "t0": t0, "wall": wall, "out": out,
            "job_dir": jobs[0], "history": found, "watch": watch}


def job_events(job: dict, tag: str) -> list:
    """The finished history of ``job``: one finalized ``.jhist.jsonl``
    (no ``.inprogress``), its event types in order."""
    from tony_tpu_torch.events import history

    check(len(job["history"]) == 1
          and job["history"][0]["jhist"].endswith(".jhist.jsonl"),
          f"{tag}: history {job['history']}")
    return [e.type.value for e in history.parse_events(
        job["history"][0]["jhist"])]


def log_time(path: str, marker: str) -> float:
    """The wall time of the first line of ``path`` holding ``marker``
    (``logging``'s ``%(asctime)s`` stamp, this host's local time)."""
    import datetime

    with open(path) as f:
        for line in f:
            if marker in line:
                return datetime.datetime.strptime(
                    line[:23], "%Y-%m-%d %H:%M:%S,%f").timestamp()
    raise PhaseError(f"no {marker!r} in {path}")


def job_walls(job: dict, res: dict) -> dict:
    """Submit to SUCCEEDED, split where the job leaves a stamp: the
    staged conf, the coordinator's endpoint file, the coordinator's log
    line of the worker's registration, and the payload's own clock."""
    jd = job["job_dir"]
    marks = [("staging", os.path.getmtime(os.path.join(jd,
                                                       "tony-final.json"))),
             ("coordinator start", os.path.getmtime(os.path.join(
                 jd, "coordinator.json"))),
             ("agent registration", log_time(os.path.join(
                 jd, "logs", "coordinator.log"), "registered worker:0")),
             ("payload start", res["t_start"]),
             ("payload start to the end of step 2", res["t_first_step"]),
             ("training (steps 3 on)", res["t_end"]),
             ("teardown to SUCCEEDED", job["t0"] + job["wall"])]
    out, last = {}, job["t0"]
    for name, t in marks:
        out[name] = t - last
        last = t
    return out


def watch_gate(job: dict, tag: str, pid: int) -> str:
    """Mid-run, only the payload (process ``pid``; and this script) held
    the card, beside the agent's ``nvidia-smi`` readings; every process
    of the job ran the port."""
    w = job["watch"]
    cmds = "; ".join(sorted(set(w.cmds.values())))
    held = w.card_pids.get(pid, 0)
    check(held > 0, f"{tag}: no sample saw the payload (pid {pid}) hold "
          f"the card ({w.samples} samples; holders {w.card_pids})")
    check(not ({"coordinator", "agent", "client", "shell"} & set(w.card)),
          f"{tag}: a job process besides the payload held the card: "
          f"{w.card}")
    roles = sorted({job_role(c) for c in w.cmds.values()})
    check({"client", "coordinator", "agent", "payload"} <= set(roles),
          f"{tag}: the job's processes were {roles}: {cmds}")
    check(not re.search(r"-m tony_tpu\.", cmds)
          and "tony_tpu_torch.agent" in cmds,
          f"{tag}: a job process ran the JAX package: {cmds}")
    check(all(len(a) <= 2 for a in w.apps),
          f"{tag}: the card's compute processes mid-run {w.apps}: more "
          "than the payload and this script")
    return (f"{w.samples} samples, the card held by the payload in "
            f"{held}, by the agent's nvidia-smi in {w.card.get('smi', 0)}; "
            "compute processes mid-run "
            f"{[len(a) for a in w.apps]} (this script and the payload)")


def phase_job(ctx) -> None:
    """18: a training job through the port's control plane, on the card
    (``cli.local`` -> client -> coordinator -> agent -> payload)."""
    import torch

    from tony_tpu_torch.examples import lm_pretrain

    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"phase 18: the card's free memory {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB (this script's cache released) "
          f"[{ctx['card']}]")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_jobs_",
                            dir=os.path.join(ROOT, "build"))
    try:
        job_train(ctx, os.path.join(root, "a"), lm_pretrain)
        job_resume(ctx, os.path.join(root, "b"), lm_pretrain)
        job_memory_limit(ctx, os.path.join(root, "c"))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def job_train(ctx, root: str, lm_pretrain) -> None:
    """18a: one worker, one GPU, Qwen2.5-1.5B at full size, phase 8's
    recipe, batch and length, 8 steps."""
    os.makedirs(root)
    result = os.path.join(root, "result.json")
    task = ["--steps", str(TRAIN_STEPS), "--micro", str(TRAIN_MICRO),
            "--accum", str(TRAIN_ACCUM), "--seq-len", str(TRAIN_SEQ),
            "--max-seq-len", str(SERVE_MAX_LEN), "--lr", str(TRAIN_LR),
            "--warmup", str(TRAIN_WARMUP), "--seed", str(SEED),
            "--result", result]
    job = run_job(ctx, "18a", root, task)
    check(job["rc"] == 0, f"18a: cli.local exited {job['rc']}: "
          f"{job['out'][-2000:]}")
    types = job_events(job, "18a")
    check(job["history"][0]["status"] == "SUCCEEDED"
          and types[-1] == "APPLICATION_FINISHED",
          f"18a: history {job['history'][0]['status']}, events {types}")
    with open(result) as f:
        res = json.load(f)
    check(res["cuda_visible_devices"] == "0",
          f"18a: the payload saw CUDA_VISIBLE_DEVICES="
          f"{res['cuda_visible_devices']!r}")
    n = res["launches"]
    check(all(v > 0 for v in n.values()), f"18a: launches {n}")
    watched = watch_gate(job, "18a", res["pid"])
    losses, want = res["losses"], ctx["fit"]["losses"]
    check(len(losses) == TRAIN_STEPS and losses[-1] < losses[0],
          f"18a: losses {losses}")
    diff = max(abs(a - b) for a, b in zip(losses, want))
    check(losses == want, f"18a: losses {losses} against phase 8's {want} "
          f"(max |diff| {diff:.3g}; held bit-equal, as phase 8 holds its "
          "replays to its eager steps)")
    cfg = lm_pretrain.train_config(QWEN25_15B, SERVE_MAX_LEN)
    flops = train_flops_per_token(cfg, res["n_params"]) \
        * res["tokens_per_step"]
    mfu = flops / (res["step_ms"] / 1e3) / PEAK_BF16
    fit8 = ctx["fit"]
    walls = job_walls(job, res)
    ctx["job_launches"] = n
    print(f"phase 18a a job on the card: cli.local -> client -> "
          f"coordinator -> agent -> lm_pretrain.py, one worker with "
          f"tony.worker.chips=1, Qwen2.5-1.5B {res['n_layers']} layers, "
          f"{TRAIN_MICRO} x {TRAIN_ACCUM} x {TRAIN_SEQ} tokens a step, "
          f"{TRAIN_STEPS} steps: SUCCEEDED, history {types}; the payload "
          f"saw CUDA_VISIBLE_DEVICES={res['cuda_visible_devices']} on "
          f"{res['device']}; losses "
          f"{[round(x, 4) for x in losses]} bit-equal to phase 8's; "
          f"{res['step_ms']:.1f} ms/step, MFU {mfu:.4f} (phase 8 in "
          f"process {fit8['step_ms']:.1f} ms/step, MFU {fit8['mfu']:.4f}); "
          f"{watched} [{ctx['card']}]")
    print(f"phase 18a job launches (the payload's process, replays "
          f"included): {json.dumps(n)}")
    print(f"phase 18a submit to SUCCEEDED {job['wall']:.2f} s: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()))


def job_resume(ctx, root: str, lm_pretrain) -> None:
    """18b: the same width at 2 layers; attempt 0 fails after the
    checkpoint at step 4, the retry resumes there; against an
    uninterrupted 8-step run in this process."""
    import torch

    from tony_tpu_torch.train import fit

    os.makedirs(root)
    layers, stop = 2, 4
    task = ["--layers", str(layers), "--steps", str(TRAIN_STEPS),
            "--micro", str(TRAIN_MICRO), "--accum", str(TRAIN_ACCUM),
            "--seq-len", str(TRAIN_SEQ), "--max-seq-len",
            str(SERVE_MAX_LEN), "--seed", str(SEED),
            "--fail-after-checkpoint", str(stop), "--result",
            os.path.join(root, "r{attempt}.json"), "--save-params",
            os.path.join(root, "params.pt")]
    job = run_job(ctx, "18b", root, task, "tony.coordinator.retry-count=1",
                  "tony.application.checkpoint-dir=ckpt")
    check(job["rc"] == 0, f"18b: cli.local exited {job['rc']}: "
          f"{job['out'][-2000:]}")
    types = job_events(job, "18b")
    check(job["history"][0]["status"] == "SUCCEEDED",
          f"18b: history {job['history'][0]['status']}")
    with open(os.path.join(job["job_dir"], "logs",
                           "coordinator.log")) as f:
        coord = f.read()
    check("task worker:0 registered exit code 1" in coord
          and "attempt 0 failed" in coord,
          "18b: attempt 0 did not exit 1 (coordinator log)")
    res = []
    for a in (0, 1):
        with open(os.path.join(root, f"r{a}.json")) as f:
            res.append(json.load(f))
    check(res[0]["steps_run"] == stop and res[1]["resumed_from"] == stop
          and res[1]["steps"] == list(range(stop + 1, TRAIN_STEPS + 1)),
          f"18b: attempt 0 ran {res[0]['steps_run']} steps, attempt 1 "
          f"resumed from {res[1]['resumed_from']} and ran "
          f"{res[1]['steps']}")
    got = torch.load(os.path.join(root, "params.pt"), weights_only=True)
    hf = {**QWEN25_15B, "num_hidden_layers": layers}
    cfg = lm_pretrain.train_config(hf, SERVE_MAX_LEN, dtype=torch.bfloat16)
    _, trainer, loader = lm_pretrain.build(
        cfg, seed=SEED, micro=TRAIN_MICRO, accum=TRAIN_ACCUM,
        seq_len=TRAIN_SEQ, lr=TRAIN_LR, warmup=TRAIN_WARMUP, device=DEVICE)
    ref = fit(trainer, None, loader, total_steps=TRAIN_STEPS, log_every=1)
    want = [h["loss"] for h in ref.history if "loss" in h]
    worst = max((got[n].to(DEVICE) - t).abs().max().item()
                for n, t in ref.state.params.items())
    check(res[1]["losses"][-1] == want[-1] and worst == 0.0,
          f"18b: the resumed run's last loss {res[1]['losses'][-1]} "
          f"against the uninterrupted {want[-1]}, params max |diff| "
          f"{worst:.3g} (held bit-equal)")
    del ref, trainer, loader, got
    torch.cuda.empty_cache()
    save = res[0]["checkpoint"]["saves"][-1]
    restore = res[1]["checkpoint"]["restores"][0]
    print(f"phase 18b retry and resume: Qwen2.5-1.5B width, {layers} "
          f"layers, checkpoint dir set, tony.coordinator.retry-count=1, "
          f"--fail-after-checkpoint {stop}: attempt 0 exited 1 after "
          f"step {stop}, attempt 1 resumed at step "
          f"{res[1]['resumed_from']} and ran steps {res[1]['steps']}; "
          f"SUCCEEDED, history {types}; the last loss "
          f"{res[1]['losses'][-1]:.6f} and every fp32 master bit-equal to "
          f"an uninterrupted {TRAIN_STEPS}-step run in this process; the "
          f"checkpoint {save['bytes']} B, saved in {save['s']:.3f} s, "
          f"restored (read to the host) in {restore['s']:.3f} s; wall "
          f"{job['wall']:.2f} s [{ctx['card']}]")


def job_memory_limit(ctx, root: str) -> None:
    """18c: a payload that only starts the card, under
    ``tony.worker.memory=64g`` (the launcher's ``RLIMIT_AS``) and without
    it. The unlimited job must succeed; the limited one is a reading."""
    cmd = f"{sys.executable} -c \"import torch; " \
        f"print(torch.ones(1, device='{DEVICE}').item())\""
    outs = {}
    for tag, confs in (("unset", ()), ("64g", ("tony.worker.memory=64g",))):
        job = run_job(ctx, f"18c {tag}", os.path.join(root, tag), [],
                      *confs, command=cmd)
        with open(os.path.join(job["job_dir"], "logs",
                               "worker-0-user.log")) as f:
            user = f.read().strip()
        outs[tag] = (job["rc"], job["history"][0]["status"]
                     if job["history"] else "no history", user[-300:])
    check(outs["unset"][0] == 0 and outs["unset"][1] == "SUCCEEDED",
          f"18c: the job without a memory limit: {outs['unset']}")
    print(f"phase 18c memory limit, a payload that only runs "
          f"torch.ones(1, device='{DEVICE}'): without tony.worker.memory "
          f"{outs['unset'][1]} (exit {outs['unset'][0]}); with "
          f"tony.worker.memory=64g (RLIMIT_AS) {outs['64g'][1]} (exit "
          f"{outs['64g'][0]}), the payload printed {outs['64g'][2]!r} "
          f"[{ctx['card']}]")


def mistral_kernel_line(ctx) -> dict:
    m = ctx["mistral_call"]
    return {"name": "flash_decode (Mistral-7B-v0.1, window 4096)",
            "route": "cuda", "source": "tony_tpu_torch/csrc/flash_decode.cu",
            "replaces": "tony_tpu/ops/decode.py:70",
            "launches": ctx["mistral_launches"],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "tony_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (no "
              "tony_tpu_torch/ beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = {"card": card()}
    ctx["flush"] = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    t_all = time.perf_counter()
    for name, phase in (("build", phase_build), ("kernel", phase_kernel),
                        ("model", phase_model), ("serve", phase_serve),
                        ("cli", phase_cli),
                        ("train-kernels", phase_train_kernels),
                        ("grad-check", phase_grad_check),
                        ("fit", phase_fit),
                        ("int8-kernels", phase_int8_kernels),
                        ("int8-model", phase_int8_model),
                        ("int8-generate", phase_int8_generate),
                        ("int8-cli", phase_int8_cli),
                        ("serving-options", phase_serving_options),
                        ("unpaged-mistral", phase_unpaged_mistral),
                        ("unpaged-qwen", phase_unpaged_qwen),
                        ("unpaged-cli", phase_unpaged_cli),
                        ("gateway", phase_gateway),
                        ("gateway-cli", phase_gateway_cli),
                        ("sampled", phase_sampled),
                        ("fabric", phase_fabric), ("job", phase_job)):
        t0 = time.perf_counter()
        try:
            phase(ctx)
        except Exception:  # noqa: BLE001 — report the phase, then fail
            traceback.print_exc()
            print(f"chip_smoke: phase {name} failed", file=sys.stderr)
            return 1
        print(f"  ({name}: {time.perf_counter() - t0:.1f} s)")
    try:
        kernels = [kernel_line(ctx), mistral_kernel_line(ctx)] \
            + train_kernel_lines(ctx) + int8_kernel_lines(ctx)
    except Exception:  # noqa: BLE001
        traceback.print_exc()
        return 1
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(ctx["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
