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
   512-key window, three packed segments, L=2047, an MHA shape with
   D=64 and phase 19b's B=8, L=8, each output held per element to
   ``ops.attention.error_bound``;
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
13. Serving options, each on phase 4's configuration at
   ``OPTIONS_LAYERS`` (14) of its 28 layers (the smoke's clock; a fresh
   Server a part, each held to 13a's Server without speculation at that
   depth; every run held to ``check_run``: requests finished as budget
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
   a. Mistral-7B-v0.1 at full width and ``MISTRAL_LAYERS`` (16) of its
      32 layers (the smoke's clock; published config, ``max_seq_len``
      8192, seeded random bf16 weights) through
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
   a. two replicas of phase 4's serving configuration cut to
      ``GATEWAY_LAYERS`` (7) of its 28 layers (the smoke's clock; the
      same seeded bf16 weights, shared) behind ``GatewayEdge`` on
      ``127.0.0.1:0``, started cold, so that both replicas capture
      their first graphs in the same run; phase 4's 24 requests sent at
      once by 24 HTTP clients, every second one streamed as NDJSON:
      every response 200, each stream equal to one ``Server``'s of the
      same model (phase 4's configuration at that depth, run first) or
      parting at a near tie,
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

16. Sampled serving and generation, all through replayed graphs, at
   15a's ``GATEWAY_LAYERS`` (7) of phase 4's 28 layers (the smoke's
   clock):
   a. phase 4's configuration and 24 requests, every second one sampled
      (temperature 0.8, top-k 50 on half of those and none on the
      others, a seed each), cold and then warm: every chunk a capture or
      a replay (none eager) and ``check_run``; tok/s, TTFT and seconds
      capturing beside 15a's one greedy Server at that depth; the greedy
      requests' streams equal that Server's or parting at a near tie;
      each sampled request served
      alone equal to its stream in the mix, or parting at a near tie of
      its draw (``sampled_parting``);
   b. with speculation on, on one saved state (pool and keys), a sampled
      chunk and a sampled verify round each replayed and eager: tokens,
      keys and pool bytes bit-equal; both timed, beside the greedy
      variant of the chunk, and the sampler's device time a micro-step;
   c. ``generate`` with temperature 0.8, top-k 50 and top-p 0.9 at batch
      8, 512-token prompts, 128 tokens, replayed and eager from one
      generator state: tokens bit-equal; tok/s beside phase 11's greedy.

17. Remote replicas and the KV fabric: 15a's model (phase 4's at
   ``GATEWAY_LAYERS`` of its 28 layers, the smoke's clock) written to a
   checkpoint directory (``max_position_embeddings`` 4096, the end-of-text
   ids) and read back by ``python -m tony_tpu_torch.cli.replica`` agents
   (bf16, batch 8, pages of 64, a 64 MB prefix store, flash-decode),
   two of them, and two more over phase 5's 2-layer checkpoint in fp32,
   all four booting at once:
   a. the two bf16 agents behind a ``Gateway`` of ``RemoteServer``s, cold,
      phase 4's 24 requests: tok/s, TTFT p50/p99, each agent's seconds
      capturing, peak memory and flash-decode launches (read from the
      agent, n_layers a single-token micro-step, replays included);
      streams near-tie equal to 15a's one ``Server`` of the model;
   c. (bf16) a greedy and a sampled stream (512-token prompt, budget
      768) each moved to the other agent by ``Gateway.migrate_session``
      after 64 tokens: freeze-to-resume ms, pages and bytes moved, the
      gateway's host spans; each near-tie equal to the same request
      unmoved (the sampled one by the rule of a draw); after 17d the move
      in parts, with the source agent in this process, idle and busy;
   b. roles prefill=1, decode=1 over the same two agents, phase 4's
      traffic: handoffs, each request's payload bytes and pages on the
      wire, TTFT, tok/s, streams near-tie equal to 15a's ``Server``, no
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
19. Fine-tuning and image training:
   a. LoRA SFT of Qwen2.5-1.5B at full width and depth (a bf16 base,
      random from the seed, frozen; rank 8, alpha 16 on q, v, o, wi,
      wo): 32 seeded prompt/completion pairs through the byte tokenizer,
      ``InstructionSource`` at 2048 tokens, ``DataLoader`` and
      ``device_prefetch``, phase 8's 4 x 2 batch, ``FusedAdamW`` with
      weight decay 0, 10 steps captured: the adapter count equal to the
      JAX rule's, launches 56 a step of each attention kernel and one
      AdamW, the last two losses below the first two; ms a step,
      positions/s (prompt, completion and padding), prompt and
      completion tokens/s and completion tokens/s, peak memory beside
      phase 8's, the optimizer state's bytes; 3 replayed and 3 eager
      steps bit-equal from one saved state; every base tensor bit-equal
      before and after; the materialized model's logits within 2^-7
      max|logit| of the LoRA forward's; a greedy ``generate`` of 16
      tokens from it replayed, launching flash-decode n_layers times a
      step, and the eager step's flash-decode call (B=1) held to its
      plain version as phase 2's are; fused AdamW held bit-equal to its
      plain version over the adapters' leaf set, its three rounds
      printed;
   b. ``tony_tpu_torch/examples/sft_lora.py`` as a job through
      ``cli.local`` (one worker, one GPU, the Qwen2.5-1.5B width at 2
      layers, the toy pairs): SUCCEEDED, the payload's self-check (at
      least 3 of 4 learned), the training kernels launched in its
      process, only it holding the card; submit to SUCCEEDED;
   c. ResNet-50 (25 557 032 parameters, the JAX model's count) on
      ``SyntheticImageSource`` 224x224x3 through ``DataLoader`` and
      ``device_prefetch``, batch 128, bf16 compute over fp32
      parameters, ``FusedAdamW``, ``train=False``, 10 steps captured,
      cuDNN held to deterministic algorithms: finite losses, one AdamW
      launch a step, replayed against eager bit-equal from one saved
      state; images/s through the loader and on device-resident
      batches, the host's ms a batch, peak memory; on one batch of 128
      at 224x224, with every norm's scale, bias and statistics drawn
      from the seed, the model against a plain fp32 NCHW forward
      written here from its parameters: in fp32 the logits within
      2^-13 max|logit| and the gradient within 2^-6 of the plain one's
      in L2 norm, in bf16 (as 19c trains it) within 2^-5 and 2^-3;
      fused AdamW held bit-equal to its plain version over ResNet-50's
      leaf set, its three rounds printed.
   Each training kernel's line carries its launches by phase (8, 19a,
   19c); the flash-decode line carries 19a's.
20. Mixture of experts at Mixtral-8x7B's published width (hidden 4096,
   8 SwiGLU experts of 14336, top-2, 32/8 heads, vocabulary 32000;
   46 702 792 704 parameters, the count checked), random from the seed:
   a. bf16 at 16 of its 32 layers (93.4 GB of bf16 does not fit the
      card) through ``Server`` (paged, flash-decode, the dropless
      experts), 16 greedy requests (prompts 64-1024, budgets 32-128) at
      batch 8: tok/s, TTFT p50/p99, flash-decode launches, peak memory;
      one chunk replayed and one eager on one saved state bit-equal,
      and the replayed chunk's ms a micro-step against its bytes bound
      (every weight but the embedding); the 16 requests again with
      every dispatch eager, traced (``RouteTrace``), equal to the
      replayed run token for token; each stream against the plain full
      forward (traced too; ``route_compare``): greedy tokens near-tie
      equal at every position before the first routing difference, the
      stream equal, parting at a near tie before it or at or after it;
      the routing differences, the routers' deviations and a control
      (the plain forward over the tokens padded, a change of shape
      only) printed, the first layer's router held; then the same 16
      requests in fp32 at 4 layers (24.3 GB), eagerly, held the same
      way with every router: logits within the near-tie tolerance
      wherever no routing difference reaches, each first difference a
      near tie of the router;
   b. int8 weights (bf16 activations) at all 32 layers, built on the
      card a layer at a time (each block drawn at fp32, quantized by
      ``models.quantize.quantize_module``, loaded), through
      ``generate`` (batch 8, 512-token prompts, 128 greedy tokens, the
      step replayed): the expert-batched q8_matmul
      (``q8_matmul_experts``, one launch for all 8 experts) held to its
      plain version per element (``ops.quant.error_bound``, a rerun
      bit-equal) at every FFN product of the path's decode call (T = 8)
      and a prefill call of one prompt's rows (T = 512), the broadcast
      x's product timed beside the plain version, ``torch.
      _weight_int8pack_mm`` over the experts and the bound; tok/s, ms a
      decode step against its bytes bound, the first 8 tokens equal to
      eager ``generate``'s, the kernel's launches by route (3 x 32 a
      forward), peak memory;
   c. one block at that width, routed (capacity 1.25), flash attention,
      remat ``attn_saved``, bf16 over fp32 masters, fused AdamW, batch 2
      x 2048, 4 steps captured whole: losses falling, the aux loss
      finite, the training kernels launched once a step; phase 8's gate
      (3 replayed and 3 eager steps from one saved state bit-equal), ms
      a step and peak memory each way;
   d. a 2-layer Mixtral at test widths written as two shards and an
      index: ``cli.generate --serve``, ``cli.generate --int8`` (tokens
      equal to ``generate`` over the reader's int8 model) and
      ``cli.score --int8`` (within 5% of fp32).
21. The model zoo: GPT-2 XL (MHA, D = 64, learned positions), Pythia-1.4B
   (GPT-NeoX: MHA, D = 128, partial rotary, parallel residual), Phi-2
   (MHA, D = 80, partial rotary, a biased head) and Gemma-2B (8 query
   heads over 1 KV head of D = 256, the embedding scale, the 1 + weight
   RMSNorm) at their published configs (``ZOO``), full width and depth,
   ``max_seq_len`` the published one up to ``SERVE_MAX_LEN``; each
   checkpoint drawn on the card in bf16 from the seed under its own
   tensor names and mapped by the port's reader (``Family.convert``),
   its parameter count printed. Each serves 8 greedy requests (prompts
   64-512, budgets 32-64) through one ``Server`` (paged, batch 8,
   flash-decode, bf16), held as phase 4 is (``check_run``: every chunk a
   capture or a replay, flash-decode n_layers times a micro-step,
   replays included), its streams held to greedy decoding by the plain
   forward by the near-tie rule: tok/s, TTFT, peak memory, flash-decode
   launches by route (the MHA form on the tensor cores at D = 64 and
   128, the SIMT route at D = 80 and 256); flash-decode at the model's
   call (B = 8, S = 1024) held per element to its plain version and
   timed beside it, SDPA and its bound.
   e. a 2-layer Gemma-2B at full width as a checkpoint directory:
      ``cli.generate --serve`` from a pipe in bf16 and in fp32
      (token-exact to one ``Server`` over the reader's model), and
      ``cli.score`` in fp32 and bf16 (within 5% of each other).
22. Scanned layers and blocked attention: Qwen2.5-1.5B at full width and
   depth with ``scan_layers=True`` (every block leaf stacked ``[28,
   ...]``, the cache too), its weights phase 4's and phase 8's draw,
   stacked (``convert.stack_layers``).
   a. phase 4's 24 requests through the paged ``Server`` (batch 8,
      flash-decode, bf16), held as phase 4 is (``check_run``): the
      streams equal phase 4's token for token (on a difference, the
      first layer whose prefill output differs from the unscanned
      model's is printed); tok/s, TTFT p50/p99 and peak memory beside
      phase 4's;
   b. phase 8's fit (remat ``attn_saved``, flash attention, fused AdamW,
      the step captured whole, 8 steps) on phase 8's weights and
      batches: the 8 losses and the final masters, unstacked, bit-equal
      to phase 8's; the launches of fwd/dq/dkv/AdamW, ms a step, MFU and
      peak memory beside phase 8's (within 10% of it);
   c. ``blockwise_attention`` at Qwen's heads (12 query, 2 KV, D = 128),
      B = 1, L = 16384, bf16, blocks of 512, against the fp32
      ``reference_attention`` per element (2^-8·|want| + 1e-5·max|v|):
      the peak memory of each forward without gradients (the blocked one
      below the reference's [L, L] scores), the times of both,
      ``flash_attention`` and SDPA (a yardstick); then the scanned model
      on 1 x 8192 tokens with ``attention_backend="blockwise"`` (never
      reaching ``reference_attention``) against ``"pallas"``: the last
      position's greedy token the same, or a near tie (the smoke's bf16
      rule: within 2^-6 of the row's largest |logit|), the logits' gap
      printed.
23. Data-parallel and FSDP training over a mesh, two ranks sharing the
   one card over gloo (``MESH_LAYERS`` of Qwen2.5-1.5B's 28 layers at
   full width, phase 8's recipe and batch, ``MESH_STEPS`` steps):
   r. the reference: one process (this one), ``fit`` at
      ``accum_steps=2`` on the global batch of 8 rows, captured;
   a. FSDP: two child processes, spawned through ``distributed.
      initialize``'s env, each ``Trainer(mesh=make_mesh(MeshSpec(data=1,
      fsdp=2)), fsdp=True)`` at ``accum_steps=1`` through ``fit`` over
      the same loader (4 rows a rank): the losses and every gathered fp32
      master bit-equal to 23r's; fused AdamW launched once a step by each
      rank on its local shards (local against whole elements printed),
      flash attention forward, dQ and dK/dV ``MESH_STEPS`` x layers a
      rank;
   b. a two-worker gang: ``cli.local`` runs ``examples/lm_pretrain.py``
      with ``tony.worker.instances=2`` and no chips (both see the card),
      ``--micro 4 --accum 1`` on ``data_parallel_mesh()``: SUCCEEDED,
      both workers on gloo in a world of 2, losses bit-equal to 23r's.
   Each rank's ms a step, peak memory and seconds in collectives are
   printed; a child that fails or outlives ``MESH_TIMEOUT`` is killed
   with its process group, and its exit code and the tail of its output
   are printed before the phase fails.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches (flash-decode's include 16a's
replays, the training kernels' phase 8's, and phase 17's agents'; the
two phase 19 AdamW lines 19a's and 19c's; the expert-batched q8_matmul
lines 20b's generate by route; one flash-decode line a zoo model with
its launches in phase 21; phase 22's scanned serving and training in
``launches_by_phase``, as are phase 23's reference and each FSDP
rank's), error and times.

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


HOLD = 2_000_000  # cycles: about 1 ms of the card held busy


def cuda_time_ms(fn, reps: int, flush, hold: int = HOLD) -> float:
    """Median device time of ``fn`` over ``reps`` calls, by CUDA events.
    Before each call the 50 MB L2 cache is flushed (the decode path finds
    it cold: the other layers' weights and caches pass through it between
    calls) and the device is held busy for ``hold`` cycles (about 1 ms by
    default), so the host has enqueued all of ``fn`` before the start
    event fires and the interval is device time, not Python launch
    overhead; a caller whose host time a call exceeds that passes a
    longer ``hold``."""
    import torch

    times = []
    for _ in range(reps + 2):
        flush.zero_()
        torch.cuda._sleep(hold)
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
    round so, and every prefill (chunks included) one eager call (a
    server with its graphs off runs all of them eagerly: not checked).
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
    if srv.graphs is None:
        return c
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
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 30
    run = serve_timed(srv, reqs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
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
          f"{c['decode_steps']}; peak memory {peak:.2f} GiB "
          f"[{ctx['card']}]")
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
                     "capture_s": c["graph_capture_s"], "peak_gib": peak,
                     "base_gib": base}
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

    from tony_tpu_torch.models.generate import is_layer_key

    return [leaf for key, layer in srv.slots.cache.items()
            if is_layer_key(key) for leaf in layer.values()
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
    phases = {"4, 13-17, 20a, 22a": ctx["launches"]}
    if "scan" in ctx:
        phases["22a"] = ctx["scan"]["serve_launches"]
    if "decode_launches" in ctx.get("finetune", {}):
        phases["19a"] = ctx["finetune"]["decode_launches"]
    return {"name": "flash_decode", "route": "cuda",
            "source": "tony_tpu_torch/csrc/flash_decode.cu",
            "replaces": "tony_tpu/ops/decode.py:70",
            "launches": ctx["launches"], "launches_by_phase": phases,
            "max_abs_err": m["max_abs_err"],
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


# cycles: about 10 ms, longer than the AdamW wrapper's host time a call
# (3-5 ms over Qwen2.5-1.5B's 339 leaves, PERF.md)
ADAMW_HOLD = 20_000_000


def hold_ms(hold: int) -> float:
    """The card's time for ``torch.cuda._sleep(hold)``, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(hold)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def measure_adamw(flush, shapes=None, grad_dtype=None,
                  with_copy: bool = True,
                  weight_decay: float = 1e-4) -> dict:
    """Fused AdamW over a leaf set (default every leaf of Qwen2.5-1.5B,
    grads of phase 8's dtype, fp32 master and moments, bf16 copy: the
    group the training path launches; phase 19 gives its adapters' and
    ResNet-50's sets, fp32 grads, no copy): one step against the plain
    version, held to one fp32 step (one bf16 step for the copy), inputs
    unchanged; then the wrapper's host time and the device times. The
    device times are taken behind ``ADAMW_HOLD``, which must outlast the
    host time; one reading behind the usual ``HOLD`` is kept beside them,
    since below the host time it counts host time as well."""
    import torch

    from tony_tpu_torch.ops import adamw as adw

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    shapes = shapes or qwen_param_shapes()
    opt = adw.FusedAdamW(3e-4, weight_decay=weight_decay)
    gdt = grad_dtype or train_grad_dtype()
    params = {n: 0.02 * torch.randn(*s, device=DEVICE, generator=gen)
              for n, s in shapes.items()}
    grads = {n: (1e-3 * torch.randn(*s, device=DEVICE, generator=gen))
             .to(gdt) for n, s in shapes.items()}
    state = opt.init(params,
                     compute_dtype=torch.bfloat16 if with_copy else None)
    # one step first, so the moments are not zero (the count advances
    # in place)
    adw.fused_adamw_update(opt, grads, state, params)
    ref_p = {n: t.clone() for n, t in params.items()}
    ref_s = adw.FusedAdamWState(
        count=state.count.clone(),
        mu={n: t.clone() for n, t in state.mu.items()},
        nu={n: t.clone() for n, t in state.nu.items()},
        compute_params={n: t.clone()
                        for n, t in state.compute_params.items()}
        if with_copy else None)
    g_before = {n: t.clone() for n, t in grads.items()}
    params, state = adw.fused_adamw_update(opt, grads, state, params)
    lr, c1, c2 = adw._hyper(opt, ref_s.count)
    for n in shapes:
        adw.leaf_update_reference(
            grads[n], ref_p[n], ref_s.mu[n], ref_s.nu[n], lr, c1, c2,
            b1=opt.b1, b2=opt.b2, eps=opt.eps, wd=opt.weight_decay,
            copy=ref_s.compute_params[n] if with_copy else None)
    sync()
    check(all(torch.equal(grads[n], g_before[n]) for n in shapes),
          "fused AdamW wrote into its grads")
    del g_before
    err, bit_equal = 0.0, True
    for n in shapes:
        pairs = [(params[n], ref_p[n], 2.0 ** -23),
                 (state.mu[n], ref_s.mu[n], 2.0 ** -23),
                 (state.nu[n], ref_s.nu[n], 2.0 ** -23)]
        if with_copy:
            pairs.append((state.compute_params[n], ref_s.compute_params[n],
                          2.0 ** -8))
        for got, want, step in pairs:
            diff = (got.float() - want.float()).abs()
            excess = (diff - step * want.float().abs()).max().item()
            check(excess <= 0, f"fused AdamW {n}: exceeds one step by "
                  f"{excess:.3g}")
            err = max(err, diff.max().item())
            bit_equal = bit_equal and torch.equal(got, want)
    check(bit_equal, "fused AdamW is not bit-equal to its plain version")
    n_el = sum(t.numel() for t in params.values())
    # read g, p, mu, nu; write p, mu, nu and the bf16 copy
    nbytes = n_el * (gdt.itemsize + 3 * 4 + 3 * 4 + (2 if with_copy else 0))
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
                copy=ref_s.compute_params[n] if with_copy else None)

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
    held = hold_ms(ADAMW_HOLD)
    check(host["cached"] < held, f"fused AdamW: the wrapper's host time "
          f"{host['cached']:.3f} ms a call outlasts the timing hold "
          f"({held:.3f} ms)")
    plain_ms = cuda_time_ms(plain, 3, flush)
    del plain, ref_s
    # the yardstick: PyTorch's fused AdamW on the same params and grads
    # (fp32: its fused path needs grads of the params' dtype), no copy
    lib_params = list(ref_p.values())
    for n, t in zip(ref_p, lib_params):
        t.grad = grads[n].float()
    lib = torch.optim.AdamW(lib_params, lr=3e-4,
                            weight_decay=weight_decay, fused=True)
    lib.step()
    # kernel and library in turn, three rounds: the spread between
    # rounds of one call says how far apart two readings may fall
    rounds = [(cuda_time_ms(kernel, 5, flush, ADAMW_HOLD),
               cuda_time_ms(lib.step, 5, flush, ADAMW_HOLD))
              for _ in range(3)]
    short = cuda_time_ms(kernel, 5, flush)
    del kernel, lib, lib_params, ref_p, params, state, grads
    return {"max_abs_err": err, "bit_equal": bit_equal,
            "ms": statistics.median(r[0] for r in rounds),
            "library_ms": statistics.median(r[1] for r in rounds),
            "rounds": rounds, "host_ms": host["cached"],
            "host_built_ms": host["built"], "hold_ms": held,
            "short_hold_ms": short, "plain_ms": plain_ms, "n": n_el,
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
        # phase 19b's payload: global batch 8 at seq_len 8, one partial
        # tile a row
        ("L8-B8", 8, 8, h, kvh, d, torch.bfloat16, 0, False, False),
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
    print_rounds(a)
    torch.cuda.empty_cache()


def print_rounds(w: dict) -> None:
    print("  kernel / AdamW(fused) by round (medians of 5 calls, each "
          f"behind a {w['hold_ms']:.2f} ms hold): "
          + ", ".join(f"{k:.3f} / {lib:.3f} ms" for k, lib in w["rounds"])
          + f"; the kernel behind the usual hold of about 1 ms (the "
          f"wrapper's host time {w['host_ms']:.3f} ms a call): "
          f"{w['short_hold_ms']:.3f} ms")


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
    base = torch.cuda.memory_allocated() / 2 ** 30
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
    # phase 22b holds the scanned fit to these, bit for bit
    ctx["fit_masters"] = {n: t.to("cpu", copy=True)
                          for n, t in result.state.params.items()}
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
    it = loader.from_step(0)
    batches = [next(it) for _ in range(3)]
    it.close()
    state, gate = train_replay_gate(
        ctx, trainer, result.state, batches, counters,
        [cfg.n_layers * TRAIN_ACCUM] * 3 + [1])
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
                  "peak_gib": peak, "base_gib": base, "losses": losses,
                  "host": host,
                  "per": per}
    del result, state, trainer, model, prof, g
    torch.cuda.empty_cache()


def train_state_tensors(state) -> list:
    """Every tensor a training step writes: the masters, the count, the
    moments and the compute copies (the module's parameters)."""
    opt = state.opt_state
    return [*state.params.values(), opt.count, *opt.mu.values(),
            *opt.nu.values(), *(opt.compute_params or {}).values()]


def train_replay_gate(ctx, trainer, state, batches, counters, per_step,
                      tag: str = "phase 8"):
    """Phase 8's gate (and phase 19's): on one saved state (kept on the
    host), 3 steps replayed, then the state put back and the same 3
    steps eager: losses and masters bit-equal, and every step raising the
    ``counters``' launch counts by ``per_step``. Each way also runs an
    untimed probe (one unprofiled step for its wall, one under
    torch.profiler for the device's busy time). The captured step's
    graph and its pool (about 23 GiB in phase 8) are let go before the
    eager steps, which need that much room of their own. Returns the
    state and each way's seconds a step, peak memory and probe."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    live = train_state_tensors(state)
    saved = [t.to("cpu", copy=True) for t in live]
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
                check(rise == per_step, f"{tag} {how} step: launches "
                      f"rose by {rise}, one step is {per_step}")
            sync()
            out["step_s"][how] = (time.perf_counter() - t0) / len(batches)
            out["peak"][how] = torch.cuda.max_memory_allocated() / 2 ** 30
            if how == "replayed":
                check(graphs.calls["train_step", "replays"] == replays + 3,
                      f"{tag}: the gate's replayed steps were not replays")
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
          f"{tag}: replayed losses {out['loss']['replayed'].tolist()} "
          f"against eager {out['loss']['eager'].tolist()}")
    differ = [n for n, a, b in zip(state.params, out["masters"]["replayed"],
                                   out["masters"]["eager"])
              if not torch.equal(a, b)]
    check(not differ, f"{tag}: masters differ replayed against eager: "
          f"{differ[:4]} ({len(differ)} leaves)")
    print(f"{tag} gate: 3 steps replayed and 3 eager from one saved "
          f"state: losses {out['loss']['eager'].tolist()} and all "
          f"{len(state.params)} masters bit-equal; each step raised the "
          f"launches by {per_step} [{ctx['card']}]")
    return state, out


def mesh_launches(ctx, i: int) -> dict:
    """Phase 23's launches of training kernel ``i`` (fwd, dq, dkv,
    AdamW): the reference's, each FSDP rank's and each gang worker's."""
    m = ctx.get("mesh")
    if m is None:
        return {}
    out = {"23r": m["ref"][i]}
    for r, n in enumerate(m["ranks"]):
        out[f"23a rank {r}"] = n[i]
    for r, n in enumerate(m["gang"]):
        out[f"23b worker {r}"] = n[i]
    return out


def train_kernel_lines(ctx) -> list[dict]:
    """The training kernels at phase 6's calls; ``launches`` is phase
    8's, ``launches_by_phase`` adds phase 19's LoRA step (19a) and job
    (19b), which run the attention kernels at other shapes (19b's held
    in phase 6 as L8-B8), and phase 20's routed MoE block (20c)."""
    a, w = ctx["attention"], ctx["adamw"]
    launches = ctx["train_launches"]
    f = ctx.get("finetune", {})
    src = "tony_tpu_torch/csrc/flash_attention.cu"
    lines = []
    for i, (name, kern, plain, lib, bound, errs, site) in enumerate((
            ("flash_attention_fwd", "fwd", "plain_fwd", "lib_fwd",
             "bound_fwd", ("o", "lse"), "tony_tpu/ops/attention.py:140"),
            ("flash_attention_bwd_dq", "dq", "plain_bwd", "lib_bwd",
             "bound_dq", ("dq",), "tony_tpu/ops/attention.py:204"),
            ("flash_attention_bwd_dkv", "dkv", "plain_bwd", "lib_bwd",
             "bound_dkv", ("dk", "dv"), "tony_tpu/ops/attention.py:262"))):
        by = {"8": launches[i]}
        if "lora_launches" in f:
            by.update({"19a": f["lora_launches"][i],
                       "19b": f["job_launches"][name]})
        if "moe_train_launches" in ctx:
            by["20c"] = ctx["moe_train_launches"][i]
        if "scan" in ctx:
            by["22b"] = ctx["scan"]["train_launches"][i]
        by.update(mesh_launches(ctx, i))
        lines.append({
            "name": name, "route": "cuda", "source": src, "replaces": site,
            "launches": launches[i], "launches_by_phase": by,
            "max_abs_err": max(a["err"][e][0] for e in errs),
            "ms": a[kern], "plain_ms": a[plain], "bound_ms": a[bound][0],
            "bound_by": a[bound][1], "library_ms": a[lib]})
    lines.append({
        "name": "fused_adamw", "route": "cuda",
        "source": "tony_tpu_torch/csrc/adamw.cu",
        "replaces": "tony_tpu/ops/adamw.py:74", "launches": launches[3],
        "launches_by_phase": {"8": launches[3], **(
            {"20c": ctx["moe_train_launches"][3]}
            if "moe_train_launches" in ctx else {}), **(
            {"22b": ctx["scan"]["train_launches"][3]}
            if "scan" in ctx else {}), **mesh_launches(ctx, 3)},
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
OPTIONS_LAYERS = 14   # 13's depth: the smoke's clock (phase 4: 28)
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

    # at OPTIONS_LAYERS of 28 (the smoke's clock): every run is held to
    # 13a's Server without speculation, at the same depth
    cfg = qwen_config(dtype=torch.bfloat16, n_layers=OPTIONS_LAYERS)
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
        print(f"phase 13a speculation ({cfg.n_layers} of Qwen's 28 layers), "
              f"{name} pass, 16 greedy requests (a "
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
MISTRAL_LAYERS = 16     # 14a/14b: the smoke's clock (published: 32)
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
    cfg = mistral_config(dtype=torch.bfloat16, n_layers=MISTRAL_LAYERS)
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
        print(f"phase {part} serve Mistral-7B-v0.1 bf16 at full width, "
              f"{cfg.n_layers} of 32 layers ({n_params} params), window "
              f"{cfg.sliding_window}, "
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


GATEWAY_LAYERS = 7  # 15a, 16, 17: the smoke's clock (phase 4: 28)


def phase_gateway(ctx) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import tony_tpu_torch.models.graphs as graphs_mod
    from tony_tpu_torch.gateway import Gateway, GatewayEdge
    from tony_tpu_torch.models.transformer import Transformer
    from tony_tpu_torch.ops.decode import flash_decode

    cfg = qwen_config(dtype=torch.bfloat16, n_layers=GATEWAY_LAYERS)
    model = Transformer(cfg, device=DEVICE).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    specs = ctx["serve4"]["specs"]
    # the streams the gateway's (and phases 16's and 17's) are held to:
    # one Server of this model
    ref = serve_server(model)
    run = serve_timed(ref, requests(specs))
    want = run["results"]
    ctx["serve_cut"] = {"specs": specs, "results": want, "rate": sum(
        len(r.tokens) for r in want.values()) / run["wall"],
        "ttft": percentiles(run["first"].values()),
        "capture_s": ref.counters()["graph_capture_s"]}
    del ref, run
    torch.cuda.empty_cache()
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
          f"configuration at {cfg.n_layers} layers behind GatewayEdge, "
          f"cold, 24 HTTP clients (12 NDJSON streams): {gen} tokens in "
          f"{wall:.2f} s = {gen / wall:.1f} tok/s (phase 4, one Server "
          f"at 28 layers: {s4['rate']:.1f}); TTFT p50 {p50:.3f} s, p99 "
          f"{p99:.3f} s (phase 4: {s4['ttft'][0]:.3f} / "
          f"{s4['ttft'][1]:.3f} s); against one Server at {cfg.n_layers} "
          f"layers: {ties_text(ties, len(specs))} [{ctx['card']}]")
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
          f"{warm_wall:.2f} s, against one Server: "
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

    from tony_tpu_torch.models.hf import load_hf_dir
    from tony_tpu_torch.serve import Request, Server

    ckpt = write_checkpoint()
    proc = None
    try:
        rng = np.random.default_rng(SEED + 2)
        specs = [(rng.integers(0, 151643, n).tolist(), m)
                 for n, m in ((40, 12), (300, 20), (5, 1), (900, 8))]
        # the gateway CLI's defaults on the card: flash-decode, batch 4,
        # chunks of 1, a 64 MB prefix store, the config's end-of-text id
        model, _ = load_hf_dir(ckpt, device=DEVICE,
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

    # at 15a's depth (the smoke's clock), held to 15a's one Server of it
    cfg = qwen_config(dtype=torch.bfloat16, n_layers=GATEWAY_LAYERS)
    model = Transformer(cfg, device=DEVICE).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    specs = ctx["serve4"]["specs"]
    s4 = ctx["serve_cut"]

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
        print(f"phase 16a sampled serve, phase 4's configuration at "
              f"{cfg.n_layers} layers and 24 "
              f"requests, 12 sampled (temperature {SAMPLED_TEMP}, top-k "
              f"{SAMPLED_TOP_K} on 6, none on 6), {how}: {gen} tokens in "
              f"{run['wall']:.2f} s = {gen / run['wall']:.1f} tok/s "
              f"(15a's one greedy Server at {cfg.n_layers} layers, cold: "
              f"{s4['rate']:.1f}); TTFT p50 "
              f"{p50:.3f} s, p99 {p99:.3f} s (15a's Server: "
              f"{s4['ttft'][0]:.3f} / {s4['ttft'][1]:.3f} s); {cap_s:.2f} s "
              f"capturing (15a's Server: {s4['capture_s']:.2f} s); "
              f"{chunks} chunks: {caps} "
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
                      f"16a greedy request {i} against 15a's Server")
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
    print(f"phase 16a greedy requests against 15a's one Server: "
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
    ``models.hf.load_hf_dir`` reads back to the same model:
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
    # 15a's model (GATEWAY_LAYERS of phase 4's 28 layers, the smoke's
    # clock), held to 15a's one Server of it
    cfg = qwen_config(dtype=torch.bfloat16, n_layers=GATEWAY_LAYERS)
    model = Transformer(cfg, device=DEVICE).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    hf = dict(QWEN25_15B, num_hidden_layers=GATEWAY_LAYERS,
              max_position_embeddings=SERVE_MAX_LEN,
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
    s_cut = ctx["serve_cut"]
    specs = s_cut["specs"]
    want = s_cut["results"]
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
                  f"{gen / wall:.1f} tok/s (one Server of this model: "
                  f"{s_cut['rate']:.1f}); "
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
                  f" B a real page ({layers} layers x 2 x 2 KV heads x 128"
                  f" x 2 B x 64 tokens = {layers * 2 * 2 * 128 * 2 * 64} B) "
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
    from tony_tpu_torch.models.hf import load_hf_dir
    from tony_tpu_torch.serve import Request, Server

    rng = np.random.default_rng(SEED + 2)
    specs = [(rng.integers(0, 151643, n).tolist(), m)
             for n, m in ((40, 12), (300, 20), (5, 1), (900, 8))]
    # 200 + 48 positions stay inside one 4-page column bucket
    long_p = rng.integers(0, 151643, 200).tolist()
    knobs = [{}, dict(temperature=SAMPLED_TEMP, top_k=SAMPLED_TOP_K,
                      seed=SEED + 5)]
    model, _ = load_hf_dir(ckpt, device=DEVICE, decode_attention="flash")
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

    from tony_tpu_torch.models.hf import load_hf_dir
    from tony_tpu_torch.serve import Request, Server

    rng = np.random.default_rng(SEED + 2)
    specs = [(rng.integers(0, 151643, n).tolist(), m)
             for n, m in ((40, 12), (300, 20), (5, 1), (900, 8))]
    model, _ = load_hf_dir(ckpt, device=DEVICE, decode_attention="flash")
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
    group does not hold them). A process that is exiting reads an empty
    command line once its memory is released, before it turns zombie: it
    stays in the tree, so its children are found, but is left out of the
    result, so a sampler never overwrites what it read of it before."""
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
            parents[int(pid)] = int(ppid)
            if cmd:
                cmds[int(pid)] = cmd
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
            command: str | None = None,
            payload: str = "lm_pretrain.py", workers: int = 1,
            chips: int | None = 1, timeout: float = 900) -> dict:
    """``python -m tony_tpu_torch.cli.local --root root`` running the
    example ``payload`` over ``QWEN25_15B`` with ``task`` (or the worker
    ``command``) on ``workers`` workers holding ``chips`` GPUs each (None:
    no chips asked, every worker sees the card), watched by ``JobWatch``:
    its exit code, wall, job dir, history, watch and output."""
    from tony_tpu_torch.events import history

    argv = [sys.executable, "-m", "tony_tpu_torch.cli.local", "--root",
            root, "--device", DEVICE, "--conf",
            f"tony.worker.instances={workers}"]
    if chips is not None:
        argv += ["--conf", f"tony.worker.chips={chips}"]
    if command is None:
        hf = os.path.join(root, "config.json")
        with open(hf, "w") as f:
            json.dump(QWEN25_15B, f)
        argv += ["--executes", os.path.join(
            ROOT, "tony_tpu_torch", "examples", payload),
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
        out, _ = proc.communicate(timeout=timeout)
    finally:
        watch.stop()
        if proc.poll() is None:  # the whole job's process group
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
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


# ------------------------------------------------------- fine-tuning

LORA_RANK, LORA_ALPHA, LORA_LR = 8, 16.0, 1e-3
LORA_TARGETS = ("q", "v", "o", "wi", "wo")
LORA_PAIRS, LORA_STEPS = 32, 10
SFT_JOB_LAYERS, SFT_JOB_STEPS = 2, 100
RESNET_BATCH, RESNET_SIZE, RESNET_STEPS = 128, 224, 10
RESNET50_STAGES = (3, 4, 6, 3)  # tony_tpu/models/resnet.py:109
# 19c's model against the plain fp32 forward, the logits' error over
# max|logit| and the gradient's in L2 norm over its norm. In bf16 about
# 70 roundings of at most 2^-9 lie between input and logits, a random
# walk of about 2^-6; in fp32 the two differ only in the order of their
# sums. The gradient's limits are wider: the stem's weight gradient is a
# small sum of large terms, which magnifies every rounding under it (on
# the CPU at batch 2, 2.4e-4 in fp32 and 2.0e-2 in bf16 over the whole
# gradient)
RESNET_LOGIT_TOL, RESNET_GRAD_TOL = 2.0 ** -5, 2.0 ** -3
RESNET32_LOGIT_TOL, RESNET32_GRAD_TOL = 2.0 ** -13, 2.0 ** -6
# the JAX package's ResNet-50 (num_classes 1000) parameter count; the CPU
# tests hold the port's count equal to it (tests/test_torch_resnet.py)
RESNET50_PARAMS = 25_557_032


def sft_pairs(n: int, seed: int) -> list:
    """``n`` prompt/completion pairs from ``seed``: printable prompts of
    200-1500 bytes, each completion a fixed function of its prompt (the
    prompt reversed with its letters' case swapped, cut to 64 + len %
    449 bytes: 64-512 bytes where the prompt is that long)."""
    import numpy as np

    chars = np.frombuffer(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTU"
                          b"VWXYZ0123456789 .,", np.uint8)
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        p = rng.choice(chars, int(rng.integers(200, 1501))).tobytes()
        p = p.decode()
        rows.append({"prompt": p,
                     "completion": p[::-1].swapcase()[:64 + len(p) % 449]})
    return rows


def jax_lora_count(cfg, rank: int, targets) -> int:
    """The adapter count by the JAX package's rule
    (``tony_tpu/train/lora.py:48-52``): A ``[shape[0], r]`` and B
    ``[r, *shape[1:]]`` of each targeted kernel, in the JAX layout."""
    d, h, kvh, dh, f = (cfg.d_model, cfg.n_heads, cfg.kv_heads,
                        cfg.head_dim, cfg.d_ff)
    shapes = {"q": (d, h, dh), "k": (d, kvh, dh), "v": (d, kvh, dh),
              "o": (h, dh, d), "wg": (d, f), "wi": (d, f), "wo": (f, d)}
    per = 0
    for name in targets:
        s = shapes[name]
        rest = 1
        for x in s[1:]:
            rest *= x
        per += s[0] * rank + rank * rest
    return per * cfg.n_layers


def fit_run(trainer, data, steps: int, counters) -> dict:
    """``fit`` for ``steps`` steps with the launch counts set to 0 just
    before and read just after: losses, launches, the step's graph
    calls, ms a step (the end of step 2 to the end of the last, as phase
    8 times it), wall and peak memory."""
    import numpy as np
    import torch

    from tony_tpu_torch.train import fit

    stamps = []

    def stamp(step, metrics):
        if not stamps:
            sync()
        stamps.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    sync()
    t0 = time.perf_counter()
    result = fit(trainer, None, data, num_steps=steps, log_every=1,
                 metric_sinks=[stamp])
    sync()
    t_end = time.perf_counter()
    losses = [h["loss"] for h in result.history if "loss" in h]
    check(result.steps_run == steps and len(stamps) == steps,
          f"fit ran {result.steps_run} steps, {len(stamps)} stamps")
    check(all(np.isfinite(losses)), f"losses not finite: {losses}")
    g = trainer.graphs
    return {"result": result, "losses": losses,
            "launches": [c.launches for c in counters],
            "calls": [g.calls["train_step", w]
                      for w in ("captures", "replays", "eager")],
            "step_ms": (t_end - stamps[0]) / (steps - 2) * 1e3,
            "wall": t_end - t0,
            "peak": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_finetune(ctx) -> None:
    """19: LoRA SFT of Qwen2.5-1.5B (19a), the ``sft_lora`` payload as a
    job (19b), ResNet-50 on synthetic images (19c)."""
    import torch

    from tony_tpu_torch.ops import adamw, attention

    counters = (attention.flash_attention_fwd,
                attention.flash_attention_bwd_dq,
                attention.flash_attention_bwd_dkv, adamw.fused_adamw_update)
    ctx["finetune"] = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_sft_",
                            dir=os.path.join(ROOT, "build"))
    try:
        lora_sft(ctx, counters, root)
        torch.cuda.empty_cache()
        sft_job(ctx, os.path.join(root, "job"))
        resnet_train(ctx, counters)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()


def lora_sft(ctx, counters, root: str) -> None:
    """19a: rank-8 adapters on q, v, o, wi, wo of Qwen2.5-1.5B at full
    width and depth (a bf16 base, random from the seed) trained on
    instruction pairs, the step captured as phase 8's."""
    import torch

    import tony_tpu_torch.models.transformer as tmod
    from tony_tpu_torch.data import (ByteTokenizer, DataLoader,
                                     InstructionSource, JsonlSource,
                                     device_prefetch)
    from tony_tpu_torch.examples import lm_pretrain
    from tony_tpu_torch.models import Transformer, generate
    from tony_tpu_torch.ops import decode
    from tony_tpu_torch.ops.xent import chunked_cross_entropy
    from tony_tpu_torch.train import (FusedAdamW, Trainer, lora_init,
                                      lora_param_count, materialize_lora,
                                      wrap_apply_fn)

    cdt = torch.bfloat16
    cfg = lm_pretrain.train_config(QWEN25_15B, SERVE_MAX_LEN, dtype=cdt)
    base = Transformer(cfg, device=DEVICE).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    # the base as it was, on the host (a copy on the card would count in
    # the peak memory the phase reports)
    kept = {n: t.to("cpu", copy=True) for n, t in base.state_dict().items()}
    rows = sft_pairs(LORA_PAIRS, SEED)
    path = os.path.join(root, "pairs.jsonl")
    with open(path, "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows) + "\n")
    tok = ByteTokenizer()
    src = InstructionSource(JsonlSource(path), tok, seq_len=TRAIN_SEQ,
                            eos_id=tok.eos_id)
    gb = TRAIN_MICRO * TRAIN_ACCUM
    host = DataLoader(src, gb, seed=SEED, device="cpu")

    def base_apply(m, batch):
        hidden = m(batch["tokens"], return_hidden=True)
        return chunked_cross_entropy(
            hidden[:, :-1], m.embedding, batch["tokens"][:, 1:],
            chunk_size=lm_pretrain.XENT_CHUNK,
            mask=batch["loss_mask"][:, 1:], compute_dtype=cdt)

    lora = lora_init(torch.Generator(device=DEVICE).manual_seed(SEED + 1),
                     base, rank=LORA_RANK, targets=LORA_TARGETS)
    n_lora = lora_param_count(lora)
    want = jax_lora_count(cfg, LORA_RANK, LORA_TARGETS)
    check(n_lora == want, f"19a: {n_lora} adapter params, the JAX rule "
          f"gives {want}")
    apply_fn = wrap_apply_fn(base_apply, base, alpha=LORA_ALPHA,
                             compute_dtype=cdt)
    trainer = Trainer(lora, apply_fn, FusedAdamW(LORA_LR, weight_decay=0.0),
                      accum_steps=TRAIN_ACCUM)
    run = fit_run(trainer, device_prefetch(host, DEVICE), LORA_STEPS,
                  counters)
    losses = run["losses"]
    check(sum(losses[-2:]) < sum(losses[:2]),
          f"19a: the last two steps' loss is not below the first two's: "
          f"{losses}")
    per_step = [cfg.n_layers * TRAIN_ACCUM] * 3 + [1]
    check(run["launches"] == [n * LORA_STEPS for n in per_step],
          f"19a: launches fwd/dq/dkv/adamw {run['launches']}, expected "
          f"{per_step} a step over {LORA_STEPS} steps")
    check(run["calls"] == [1, LORA_STEPS - 1, 0],
          f"19a: train_step captures/replays/eager {run['calls']}")
    opt = run["result"].state.opt_state
    opt_bytes = sum(t.numel() * t.element_size()
                    for t in [*opt.mu.values(), *opt.nu.values()])
    masked = sum(int(src[i]["loss_mask"].sum()) for i in range(len(src)))
    # the fit's own batches (the loader's order from step 0): the prompt
    # and completion tokens a step, the rest of the 2048 positions pad
    it = host.from_step(0)
    real, completion = 0, 0
    for _ in range(LORA_STEPS):
        m = next(it)["loss_mask"]
        # a row's tokens end at its last completion position
        last = m.shape[1] - m.flip(1).argmax(1)
        real += int(last.sum())
        completion += int(m.sum())
    it.close()
    real, completion = real / LORA_STEPS, completion / LORA_STEPS
    positions = gb * TRAIN_SEQ
    fit8 = ctx["fit"]
    n_base = sum(t.numel() for t in base.parameters())
    print(f"phase 19a LoRA SFT of Qwen2.5-1.5B ({cfg.n_layers} layers, bf16 "
          f"base of {n_base} params frozen, random from seed {SEED}): rank "
          f"{LORA_RANK}, alpha {LORA_ALPHA}, targets {','.join(LORA_TARGETS)}"
          f": {n_lora} adapter params (the JAX rule's count {want}); "
          f"InstructionSource over {LORA_PAIRS} pairs at seq_len "
          f"{TRAIN_SEQ} ({masked} completion tokens in {len(src)} "
          f"examples), DataLoader -> device_prefetch, {TRAIN_MICRO} x "
          f"{TRAIN_ACCUM} a step, FusedAdamW({LORA_LR}, weight_decay=0), "
          f"{LORA_STEPS} steps captured: losses "
          f"{[round(x, 4) for x in losses]}; {run['step_ms']:.1f} ms/step, "
          f"{positions / run['step_ms'] * 1e3:.0f} positions/s, of them "
          f"{real / run['step_ms'] * 1e3:.0f} prompt and completion "
          f"tokens/s ({real:.0f} of {positions} positions a step, the rest "
          f"padding) and {completion / run['step_ms'] * 1e3:.0f} completion "
          f"tokens/s ({completion:.0f} a step), peak memory "
          f"{run['peak']:.2f} GiB (phase 8 full training on packed "
          f"sequences: {fit8['step_ms']:.1f} ms/step, {fit8['tok_s']:.0f} "
          f"positions/s, every one a token, "
          f"{fit8['peak_gib']:.2f} GiB); optimizer state (mu, nu) "
          f"{opt_bytes} B; launches fwd/dq/dkv/adamw {run['launches']} "
          f"({per_step} a step), train_step captures/replays/eager "
          f"{run['calls']} [{ctx['card']}]")
    it = host.from_step(0)
    batches = [{k: v.to(DEVICE) for k, v in next(it).items()}
               for _ in range(3)]
    it.close()
    state, gate = train_replay_gate(ctx, trainer, run["result"].state,
                                    batches, counters, per_step,
                                    tag="phase 19a")
    for how, step_s in gate["step_s"].items():
        print(f"phase 19a {how} step on one saved state: "
              f"{step_s * 1e3:.1f} ms/step, host share "
              f"{gate['probe'][how]['host']} (device busy "
              f"{gate['probe'][how]['busy_ms']:.1f} ms a step), peak "
              f"memory {gate['peak'][how]:.2f} GiB [{ctx['card']}]")
    differ = [n for n, t in base.state_dict().items()
              if not torch.equal(t.cpu(), kept[n])]
    check(not differ, f"19a: base tensors changed by training: {differ[:4]}")
    n_kept = len(kept)
    del kept
    served = Transformer(cfg, device=DEVICE)
    served.load_state_dict(materialize_lora(base, state.params,
                                            alpha=LORA_ALPHA))
    x = batches[0]["tokens"][:1]
    with torch.no_grad():
        want_logits = apply_fn.view(x)
        got = served(x)
    err = (got - want_logits).abs().max().item()
    lim = 2.0 ** -7 * want_logits.abs().max().item()
    check(err <= lim, f"19a: the materialized model's logits differ from "
          f"the LoRA forward's by {err:.4g} > {lim:.4g}")
    del want_logits, got
    prompt = torch.tensor([tok.encode(rows[0]["prompt"])], device=DEVICE)
    # the first decode step runs eagerly before its capture: keep its
    # first flash-decode call's inputs (B=1) for the kernel's check
    call = {}
    real_fd = tmod.flash_decode

    def keep(q, k, v, length, **kw):
        if not call and not torch.cuda.is_current_stream_capturing():
            call.update(args=(q.clone(), k.clone(), v.clone(),
                              torch.as_tensor(length).clone()), kw=dict(kw))
        return real_fd(q, k, v, length, **kw)

    decode.flash_decode.launches = 0
    tmod.flash_decode = keep
    try:
        out = generate(served, prompt, max_new_tokens=16)
    finally:
        tmod.flash_decode = real_fd
    c = served.graphs.counters(("generate",))
    n_fd = decode.flash_decode.launches
    check(out.shape == (1, 16) and c["generate_captures"] == 1
          and c["generate_replays"] == 14 and n_fd == cfg.n_layers * 15,
          f"19a: generate gave {tuple(out.shape)}, {c}, flash-decode "
          f"launches {n_fd} (expected 1 capture, 14 replays, "
          f"{cfg.n_layers} x 15)")
    check(bool(call), "19a: generate's eager decode step made no "
          "flash-decode call")
    q, k, v, length = call["args"]
    m = measure_decode(q, k, v, length.to(DEVICE),
                       call["kw"].get("window", 0), None, None, ctx["flush"])
    print(f"phase 19a flash_decode at generate's call (B={q.shape[0]} "
          f"H={q.shape[1]} KVH={k.shape[2]} D={q.shape[2]} S={k.shape[1]} "
          f"length {length.tolist()}, {k.dtype}; {m['route']}, "
          f"{m['nsplit']} split(s)): max abs err {m['max_abs_err']:.3g} "
          f"(worst excess {m['excess']:.3g} over {m['rtol']:.3g}*|want|, "
          f"limit {m['atol']:.3g}); kernel {m['ms'] * 1e3:.1f} us, plain "
          f"{m['plain_ms'] * 1e3:.1f} us, sdpa {m['library_ms'] * 1e3:.1f} "
          f"us, bound {m['bound_ms'] * 1e3:.2f} us [{ctx['card']}]")
    del call, q, k, v, length
    print(f"phase 19a gates: the last two losses below the first two; the "
          f"{n_kept} base tensors bit-equal before and "
          f"after; the materialized model's logits within {err:.4g} of the "
          f"LoRA forward's (limit 2^-7 max|logit| = {lim:.4g}); greedy "
          f"generate of 16 tokens from it: 1 capture, 14 replays, "
          f"flash-decode {n_fd} launches, tokens "
          f"{out[0].tolist()} [{ctx['card']}]")
    shapes = {n: tuple(p.shape) for n, p in lora.named_parameters()}
    ctx["finetune"].update(lora_launches=run["launches"], lora=run,
                           lora_gate=gate["step_s"], decode_launches=n_fd)
    del served, trainer, lora, state, gate, run, base, apply_fn, batches
    torch.cuda.empty_cache()
    w = measure_adamw(ctx["flush"], shapes, torch.float32, with_copy=False,
                      weight_decay=0.0)
    ctx["finetune"]["lora_adamw"] = w
    print_adamw(ctx, "phase 19a fused AdamW over the adapters' leaf set", w)


def print_adamw(ctx, what: str, w: dict) -> None:
    print(f"{what} ({w['n']} params, fp32 grads, master and moments, no "
          f"copy): max abs err {w['max_abs_err']:.3g}, bit-equal to the "
          f"plain version {w['bit_equal']}; kernel {w['ms']:.3f} ms, plain "
          f"{w['plain_ms']:.3f} ms, torch AdamW(fused) "
          f"{w['library_ms']:.3f} ms, bound {w['bound'][0]:.3f} ms "
          f"({w['bound'][1]}) [{ctx['card']}]")
    print_rounds(w)


def sft_job(ctx, root: str) -> None:
    """19b: ``examples/sft_lora.py`` as a job: one worker, one GPU, the
    Qwen2.5-1.5B width at 2 layers, the reference example's toy pairs."""
    os.makedirs(root)
    result = os.path.join(root, "result.json")
    task = ["--layers", str(SFT_JOB_LAYERS), "--steps", str(SFT_JOB_STEPS),
            "--seed", str(SEED), "--result", result]
    job = run_job(ctx, "19b", root, task, payload="sft_lora.py")
    check(job["rc"] == 0, f"19b: cli.local exited {job['rc']}: "
          f"{job['out'][-3000:]}")
    types = job_events(job, "19b")
    check(job["history"][0]["status"] == "SUCCEEDED",
          f"19b: history {job['history'][0]['status']}, events {types}")
    with open(result) as f:
        res = json.load(f)
    check(res["hits"] is not None and res["hits"] >= 3,
          f"19b: the payload's self-check learned {res['hits']} of 4")
    n = res["launches"]
    check(all(v > 0 for v in n.values()), f"19b: launches {n}")
    ctx["finetune"]["job_launches"] = n
    watched = watch_gate(job, "19b", res["pid"])
    from tony_tpu_torch.examples import lm_pretrain

    cfg = lm_pretrain.train_config(
        {**QWEN25_15B, "num_hidden_layers": SFT_JOB_LAYERS}, 8)
    want = jax_lora_count(cfg, LORA_RANK, LORA_TARGETS)
    check(res["adapter_params"] == want,
          f"19b: {res['adapter_params']} adapter params, the JAX rule "
          f"gives {want}")
    print(f"phase 19b the sft_lora payload as a job: cli.local, one "
          f"worker, tony.worker.chips=1, Qwen2.5-1.5B width at "
          f"{res['n_layers']} layers, the toy pairs, {res['steps_run']} "
          f"steps: SUCCEEDED, history {types}; learned {res['hits']}/4; "
          f"{res['adapter_params']} adapter params; losses "
          f"{[round(x, 4) for x in res['losses']]}; the payload's "
          f"launches {json.dumps(n)}; submit to SUCCEEDED "
          f"{job['wall']:.2f} s (payload start to fit "
          f"{res['t_fit'] - res['t_start']:.2f} s, fit "
          f"{res['t_end'] - res['t_fit']:.2f} s); {watched} "
          f"[{ctx['card']}]")


def resnet_train(ctx, counters) -> None:
    """19c: ResNet-50 on synthetic ImageNet-shaped data through the
    ``Trainer`` (bf16 compute over fp32 parameters, ``FusedAdamW``,
    ``train=False`` with the statistics frozen, as the JAX ``Trainer``
    trains it), the step captured, cuDNN held to deterministic
    algorithms so that a replay can be held bit-equal to an eager step."""
    import torch
    import torch.nn.functional as F

    from tony_tpu_torch.data import (DataLoader, SyntheticImageSource,
                                     device_prefetch)
    from tony_tpu_torch.models import ResNet50
    from tony_tpu_torch.train import FusedAdamW, Trainer

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model = ResNet50(num_classes=1000, num_filters=64,
                         dtype=torch.bfloat16, device=DEVICE).init_weights(
            torch.Generator(device=DEVICE).manual_seed(SEED))
        n_params = sum(p.numel() for p in model.parameters())
        check(n_params == RESNET50_PARAMS, f"19c: {n_params} params, the "
              f"JAX ResNet-50 has {RESNET50_PARAMS}")
        src = SyntheticImageSource(4 * RESNET_BATCH, RESNET_SIZE,
                                   RESNET_SIZE, 3, num_classes=1000,
                                   seed=SEED)
        host = DataLoader(src, RESNET_BATCH, seed=SEED, device="cpu")
        # the host's cost of a batch alone, one thread, no device work
        draw = host._host_batches()
        t0 = time.perf_counter()
        for _ in range(2):
            next(draw)
        host_ms = (time.perf_counter() - t0) / 2 * 1e3
        draw.close()

        def apply_fn(m, batch):
            logits = m(batch["image"], train=False)
            return F.cross_entropy(logits, batch["label"].long())

        trainer = Trainer(model, apply_fn, FusedAdamW(1e-3))
        run = fit_run(trainer, device_prefetch(host, DEVICE),
                      RESNET_STEPS, counters)
        check(run["launches"] == [0, 0, 0, RESNET_STEPS],
              f"19c: launches fwd/dq/dkv/adamw {run['launches']}, expected "
              f"AdamW once a step")
        check(run["calls"] == [1, RESNET_STEPS - 1, 0],
              f"19c: train_step captures/replays/eager {run['calls']}")
        it = host.from_step(0)
        batches = [{k: v.to(DEVICE) for k, v in next(it).items()}
                   for _ in range(3)]
        it.close()
        _, gate = train_replay_gate(ctx, trainer, run["result"].state,
                                    batches, counters, [0, 0, 0, 1],
                                    tag="phase 19c")
        replay_ms = gate["step_s"]["replayed"] * 1e3
        bound = "the host's data" if host_ms > replay_ms else "the card"
        print(f"phase 19c ResNet-50 ({n_params} params, the JAX model's "
              f"count), SyntheticImageSource {RESNET_SIZE}x{RESNET_SIZE}x3, "
              f"batch {RESNET_BATCH}, DataLoader -> device_prefetch, bf16 "
              f"compute over fp32 params, FusedAdamW, train=False, "
              f"{RESNET_STEPS} steps captured: losses "
              f"{[round(x, 4) for x in run['losses']]}; "
              f"{run['step_ms']:.1f} ms/step through the loader, "
              f"{RESNET_BATCH / run['step_ms'] * 1e3:.0f} images/s; the "
              f"host draws a batch ({RESNET_BATCH * 3 * RESNET_SIZE ** 2} "
              f"normals) in {host_ms:.1f} ms on one thread; a replayed "
              f"step on device-resident batches {replay_ms:.1f} ms "
              f"({RESNET_BATCH / replay_ms * 1e3:.0f} images/s), host share "
              f"{gate['probe']['replayed']['host']}, eager "
              f"{gate['step_s']['eager'] * 1e3:.1f} ms: {bound} bounds the "
              f"step (the card idle "
              f"{max(0.0, 1 - replay_ms / run['step_ms']):.3f} of the fit's "
              f"steps through the loader); peak memory {run['peak']:.2f} GiB; AdamW launches "
              f"{run['launches'][3]}, train_step captures/replays/eager "
              f"{run['calls']} [{ctx['card']}]")
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        ctx["finetune"].update(resnet_launches=run["launches"][3],
                               resnet={"step_ms": run["step_ms"],
                                       "replay_ms": replay_ms,
                                       "host_ms": host_ms})
        batch = batches[0]
        del trainer, model, run, gate, batches
        torch.cuda.empty_cache()
        resnet_plain_check(ctx, batch)
        del batch
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    w = measure_adamw(ctx["flush"], shapes, torch.float32, with_copy=False)
    ctx["finetune"]["resnet_adamw"] = w
    print_adamw(ctx, "phase 19c fused AdamW over ResNet-50's leaf set", w)


def resnet_plain_logits(p: dict, x):
    """ResNet-50's ``train=False`` forward written plainly from its
    state_dict ``p``: fp32, NCHW, contiguous, flax's ``"SAME"`` padding
    worked out here (the odd pixel last), the max pool padded with
    -inf, the norms by their running statistics."""
    import torch
    import torch.nn.functional as F

    def same(n: int, k: int, s: int) -> tuple[int, int]:
        total = max((-(-n // s) - 1) * s + k - n, 0)
        return total // 2, total - total // 2

    def conv(x, name: str, stride: int, pad: int | None = None):
        w = p[f"{name}.weight"]
        if pad is None:
            (t, b), (lt, r) = (same(n, w.shape[-1], stride)
                               for n in x.shape[2:])
        else:
            t = b = lt = r = pad
        return F.conv2d(F.pad(x, (lt, r, t, b)), w, stride=stride)

    def norm(x, name: str):
        mul = torch.rsqrt(p[f"{name}.var"] + 1e-5) * p[f"{name}.scale"]
        return (x - p[f"{name}.mean"][:, None, None]) * mul[:, None, None] \
            + p[f"{name}.bias"][:, None, None]

    x = x.float().permute(0, 3, 1, 2).contiguous()
    x = F.relu(norm(conv(x, "conv_init", 2, 3), "bn_init"))
    (t, b), (lt, r) = (same(n, 3, 2) for n in x.shape[2:])
    x = F.max_pool2d(F.pad(x, (lt, r, t, b), value=-float("inf")), 3, 2)
    i = 0
    for stage, size in enumerate(RESNET50_STAGES):
        for j in range(size):
            pre = f"blocks.{i}"
            stride = 2 if stage > 0 and j == 0 else 1
            y = F.relu(norm(conv(x, f"{pre}.convs.0", 1), f"{pre}.norms.0"))
            y = F.relu(norm(conv(y, f"{pre}.convs.1", stride),
                            f"{pre}.norms.1"))
            y = norm(conv(y, f"{pre}.convs.2", 1), f"{pre}.norms.2")
            if f"{pre}.conv_proj.weight" in p:
                x = norm(conv(x, f"{pre}.conv_proj", stride),
                         f"{pre}.norm_proj")
            x = F.relu(x + y)
            i += 1
    return F.linear(x.mean(dim=(2, 3)), p["head.weight"], p["head.bias"])


def resnet_plain_check(ctx, batch) -> None:
    """19c's ResNet-50 on one of its batches against
    ``resnet_plain_logits``, run in fp32 (the module's structure, held
    close) and in bf16 as 19c trains it (channels-last, cuDNN; held to
    bf16's precision): the logits, and the gradient of the
    cross-entropy over all parameters as one vector. The norms' scales,
    biases and statistics are drawn from the seed first (scale 1 + 0.2
    N, bias and mean 0.1 N, var 1 + 0.3 |N|, as the CPU tests draw
    them), so no block's branch is zero, as each is at init."""
    import torch
    import torch.nn.functional as F

    from tony_tpu_torch.models import ResNet50
    from tony_tpu_torch.models.resnet import BatchNorm

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
    model = ResNet50(num_classes=1000, num_filters=64, dtype=torch.float32,
                     device=DEVICE).init_weights(gen)

    def draw(t):
        return torch.randn(t.shape, device=DEVICE, generator=gen)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.scale.copy_(1 + 0.2 * draw(m.scale))
                m.bias.copy_(0.1 * draw(m.bias))
                m.mean.copy_(0.1 * draw(m.mean))
                m.var.copy_(1 + 0.3 * draw(m.var).abs())
    x, label = batch["image"], batch["label"].long()
    p = {n: t.detach().clone().requires_grad_()
         for n, t in model.named_parameters()}
    p.update({n: t.detach().clone() for n, t in model.named_buffers()})
    names = [n for n, _ in model.named_parameters()]

    def run(forward, params):
        logits = forward(x)
        F.cross_entropy(logits, label).backward()
        sync()
        check(bool(torch.isfinite(logits).all()),
              "19c check: logits not finite")
        return logits.detach(), torch.cat([params[n].grad.flatten()
                                           for n in names])

    want, want_g = run(lambda x: resnet_plain_logits(p, x), p)
    del p
    top, g_norm = want.abs().max().item(), want_g.norm().item()
    out = {}
    for dt, tol, gtol in ((torch.float32, RESNET32_LOGIT_TOL,
                           RESNET32_GRAD_TOL),
                          (torch.bfloat16, RESNET_LOGIT_TOL,
                           RESNET_GRAD_TOL)):
        if dt != torch.float32:
            m = ResNet50(num_classes=1000, num_filters=64, dtype=dt,
                         device=DEVICE)
            m.load_state_dict(model.state_dict())
            model = m
        got, got_g = run(lambda x: model(x, train=False),
                         dict(model.named_parameters()))
        err = (got - want).abs().max().item() / top
        g_err = (got_g - want_g).norm().item() / g_norm
        name = str(dt).split(".")[-1]
        check(err <= tol, f"19c: the {name} model's logits differ from "
              f"the plain fp32 forward's by {err:.4g} of max|logit| > "
              f"{tol:.4g}")
        check(g_err <= gtol, f"19c: the {name} model's gradient differs "
              f"from the plain one's by {g_err:.4g} of its norm > "
              f"{gtol:.4g}")
        out[name] = (err, g_err)
    print(f"phase 19c check on one batch ({x.shape[0]} x {RESNET_SIZE}x"
          f"{RESNET_SIZE}x3), the norms drawn from the seed, against a "
          f"plain fp32 NCHW forward (max|logit| {top:.4g}): "
          + "; ".join(f"the {n} channels-last model's logits within "
                      f"{e:.4g} of max|logit|, its gradient within {g:.4g} "
                      f"of the plain one's in L2 norm"
                      for n, (e, g) in out.items())
          + f" (limits: fp32 {RESNET32_LOGIT_TOL:.3g} and "
          f"{RESNET32_GRAD_TOL:.3g}, bf16 {RESNET_LOGIT_TOL:.3g} and "
          f"{RESNET_GRAD_TOL:.3g}) [{ctx['card']}]")


def finetune_kernel_lines(ctx) -> list[dict]:
    """Fused AdamW at the leaf sets phase 19 gives it, the adapters'
    (19a, and 19b's at two layers) and ResNet-50's (19c); the attention
    kernels' and flash-decode's phase 19 launches are on their own
    lines."""
    f = ctx["finetune"]
    lines = []
    for tag, w, by in (
            ("19a LoRA adapters", f["lora_adamw"],
             {"19a": f["lora_launches"][3],
              "19b": f["job_launches"]["fused_adamw"]}),
            ("19c ResNet-50", f["resnet_adamw"],
             {"19c": f["resnet_launches"]})):
        lines.append({
            "name": f"fused_adamw ({tag})", "route": "cuda",
            "source": "tony_tpu_torch/csrc/adamw.cu",
            "replaces": "tony_tpu/ops/adamw.py:74",
            "launches": next(iter(by.values())), "launches_by_phase": by,
            "max_abs_err": w["max_abs_err"], "ms": w["ms"],
            "plain_ms": w["plain_ms"], "bound_ms": w["bound"][0],
            "bound_by": w["bound"][1], "library_ms": w["library_ms"]})
    return lines


def mistral_kernel_line(ctx) -> dict:
    m = ctx["mistral_call"]
    return {"name": "flash_decode (Mistral-7B-v0.1, window 4096)",
            "route": "cuda", "source": "tony_tpu_torch/csrc/flash_decode.cu",
            "replaces": "tony_tpu/ops/decode.py:70",
            "launches": ctx["mistral_launches"],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"]}


# ------------------------------------------ mixture of experts (phase 20)

# Mixtral-8x7B-v0.1, https://huggingface.co/mistralai/Mixtral-8x7B-v0.1
# config.json
MIXTRAL_8X7B = {
    "model_type": "mixtral", "architectures": ["MixtralForCausalLM"],
    "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "num_local_experts": 8,
    "num_experts_per_tok": 2, "vocab_size": 32000, "hidden_act": "silu",
    "rope_theta": 1e6, "rms_norm_eps": 1e-5, "sliding_window": None,
    "tie_word_embeddings": False, "max_position_embeddings": 32768,
    "router_aux_loss_coef": 0.02, "bos_token_id": 1, "eos_token_id": 2,
    "torch_dtype": "bfloat16",
}
MIXTRAL_PARAMS = 46_702_792_704  # the published model's count
MIXTRAL_SERVE_LAYERS = 16  # 20a: 93.4 GB of bf16 at 32 layers
MIXTRAL_FP32_LAYERS = 4    # 20a's fp32 check: 24.3 GB
MIXTRAL_MAX_LEN = 4096     # 20a/20b cap (published: 32768)
MIXTRAL_EOS = (2,)         # </s>
MOE_TRAIN_SEQ, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS = 2048, 2, 4
MOE_PREFILL_ROWS = 512     # 20b's prefill kernel call: one prompt's rows
XENT_CHUNK_MOE = 2048


def mixtral_config(**overrides):
    from tony_tpu_torch.models.hf import mixtral_config as make

    kw = dict(max_seq_len=MIXTRAL_MAX_LEN, decode_attention="flash")
    kw.update(overrides)
    return make(MIXTRAL_8X7B, **kw)


def init_block(block, gen) -> None:
    """``Transformer.init_weights``' rule on one block: N(0, 0.02)
    weights, unit norm scales."""
    import torch

    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.rsplit(".", 1)[-1] == "scale":
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)


def int8_mixtral(layers: int, max_seq_len: int):
    """Mixtral-8x7B with int8 weights (bf16 activations) at ``layers``
    layers, random from the seed, built on the card one layer at a time:
    each block is drawn at fp32 on the card, quantized there by
    ``models.quantize.quantize_module`` and loaded into the int8 model
    before the next is drawn, so the fp32 model (187 GB) never exists."""
    import dataclasses

    import torch

    from tony_tpu_torch.models.quantize import quantize_module
    from tony_tpu_torch.models.transformer import Block, Transformer

    fcfg = mixtral_config(n_layers=layers, max_seq_len=max_seq_len,
                          dtype=torch.float32)
    qmodel = Transformer(dataclasses.replace(
        fcfg, quantized=True, dtype=torch.bfloat16), device="meta")
    qmodel.to_empty(device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    with torch.no_grad():
        qmodel.embedding.normal_(0.0, 0.02, generator=gen)
        qmodel.lm_head.normal_(0.0, 0.02, generator=gen)
        qmodel.ln_f.scale.fill_(1.0)
    for i in range(layers):
        block = Block(fcfg, device=DEVICE, use_moe=True)
        init_block(block, gen)
        qmodel.blocks[i].load_state_dict(quantize_module(block),
                                         strict=True)
        del block
    torch.cuda.empty_cache()
    return qmodel


def q8e_bound(x, w_q, out_dtype) -> tuple[float, str]:
    """Least time for ``q8_matmul_experts`` on these inputs: x (once, a
    broadcast x once for all experts), every expert's int8 weights and
    scales read once and the [E, T, n] output written once, over HBM
    bandwidth, against 2 E T k n operations at the peak for x's type."""
    import torch

    e, k, n = w_q.shape
    t = x.shape[-2]
    nbytes = x.numel() * x.element_size() + w_q.numel() + 4 * e * n \
        + e * t * n * torch.empty((), dtype=out_dtype).element_size()
    peak = PEAK_OPS["float32" if x.dtype == torch.float32 else "bfloat16"]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * e * t * k * n / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def q8e_library(x, w_q, scale):
    """One PyTorch call a expert computing the same products, timed and
    never used by the port: ``torch._weight_int8pack_mm`` over each
    expert in turn (int8 weights [n, k], scales in x's dtype)."""
    import torch

    wt = [w.t().contiguous() for w in w_q]
    sc = scale.to(x.dtype)
    xs = [x] * len(wt) if x.dim() == 2 else list(x)
    return lambda: [torch._weight_int8pack_mm(a, w, s)
                    for a, w, s in zip(xs, wt, sc)]


def measure_q8e(ctx, x, w_q, scale, reps: int, time_it: bool) -> dict:
    """``q8_matmul_experts`` against its plain version on one input set:
    inputs unchanged, a rerun bit-equal, every element within
    ``ops.quant.error_bound``; then (``time_it``) the kernel, the plain
    version and the library loop timed beside the bound."""
    import torch

    from tony_tpu_torch.ops import quant

    before = [t.clone() for t in (x, w_q, scale)]
    got = quant.q8_matmul_experts(x, w_q, scale)
    sync()
    check(all(torch.equal(a, b) for a, b in zip((x, w_q, scale), before)),
          "q8_matmul_experts wrote into its inputs")
    del before
    check(torch.equal(quant.q8_matmul_experts(x, w_q, scale), got),
          f"q8_matmul_experts x{tuple(x.shape)}: a rerun gave other bits")
    want = quant.q8_matmul_experts_reference(x, w_q, scale)
    limit = quant.error_bound(x, w_q, scale, want)
    diff = (got.float() - want.float()).abs()
    check(bool(torch.isfinite(got.float()).all()),
          "q8_matmul_experts not finite")
    worst = (diff / limit.clamp_min(1e-30)).max().item()
    err = diff.max().item()
    check(worst <= 1.0, f"q8_matmul_experts x{tuple(x.shape)} "
          f"w{tuple(w_q.shape)}: |got - want| reaches {worst:.3g} of its "
          f"limit (max abs err {err:.3g})")
    del got, want, limit, diff
    e, k, n = w_q.shape
    t = x.shape[-2]
    p = quant.plan(t, n, k, x.dtype, quant._sms(x.device.index), e)
    out = {"max_abs_err": err, "of_limit": worst, "grid": p.grid,
           "route": ("decode", "tensor cores", "SIMT tile")[p.route]}
    if not time_it:
        return out
    bound_ms, bound_by = q8e_bound(x, w_q, x.dtype)
    ms = cuda_time_ms(lambda: quant.q8_matmul_experts(x, w_q, scale), reps,
                      ctx["flush"])
    plain_ms = cuda_time_ms(
        lambda: quant.q8_matmul_experts_reference(x, w_q, scale), reps,
        ctx["flush"])
    library_ms = cuda_time_ms(q8e_library(x, w_q, scale), reps,
                              ctx["flush"])
    nbytes = x.numel() * x.element_size() + w_q.numel() + 4 * e * n \
        + e * t * n * x.element_size()
    rate = (f"{nbytes / ms / 1e9:.3f} TB/s" if bound_by == "bytes"
            else f"{2.0 * e * t * k * n / ms / 1e9:.1f} TFLOP/s")
    out.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by, rate=rate)
    return out


def phase_moe(ctx) -> None:
    """Phase 20: Mixtral-8x7B's published width through the port."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 20 starts with {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB allocated [{ctx['card']}]")
    for part in (moe_serve, moe_generate, moe_train, moe_cli):
        t0 = time.perf_counter()
        part(ctx)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  ({part.__name__}: {time.perf_counter() - t0:.1f} s)")


def moe_specs(rng) -> list:
    """20a's 16 requests as (prompt, budget): prompts of 64-1024 tokens,
    budgets 32-128."""
    return [(rng.integers(0, 32000, int(rng.integers(64, 1025))).tolist(),
             int(rng.integers(32, 129))) for _ in range(16)]


def moe_serve(ctx) -> None:
    """20a: Mixtral-8x7B bf16 at full width and 16 of its 32 layers
    through ``Server`` (paged, flash-decode, dropless experts), 16 greedy
    requests at batch 8; then one chunk replayed and one eager on one
    saved state, bit-equal, and a replayed chunk timed beside the
    micro-step's bytes bound; then the streams held to the plain
    forward (``moe_route_gate``), and the same traffic in fp32
    (``moe_fp32_gate``)."""
    import numpy as np
    import torch

    from tony_tpu_torch.models.transformer import Transformer
    from tony_tpu_torch.serve import Request, Server
    from tony_tpu_torch.serve.engine import _decode_chunk

    card_ = ctx["card"]
    full = mixtral_config()
    n_full = sum(p.numel() for p in Transformer(
        full, device="meta").parameters())
    check(n_full == MIXTRAL_PARAMS, f"Mixtral-8x7B at the published config "
          f"has {n_full} parameters, not {MIXTRAL_PARAMS}")
    cfg = mixtral_config(n_layers=MIXTRAL_SERVE_LAYERS, dtype=torch.bfloat16)
    check(cfg.sliding_window == 0, "Mixtral-8x7B read with a window")
    torch.cuda.reset_peak_memory_stats()
    model = Transformer(cfg, device=DEVICE).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED + 20))
    weights = torch.cuda.memory_allocated()
    srv = Server(model, batch_size=8, eos_id=MIXTRAL_EOS, chunk_steps=8,
                 device=DEVICE)
    check(srv.paged, "20a: Mixtral-8x7B (no window) not served paged")
    specs = moe_specs(np.random.default_rng(SEED + 20))
    reqs = requests(specs)
    run = serve_timed(srv, reqs)
    c = check_run(srv, reqs, run, "20a")
    peak = torch.cuda.max_memory_allocated()
    ctx["launches"] += run["launches"]
    toks = sum(len(r.tokens) for r in run["results"].values())
    p50, p99 = percentiles(run["first"][r.id] for r in reqs)
    print(f"phase 20a serve Mixtral-8x7B bf16 ({n_full} params published; "
          f"{cfg.n_layers} of 32 layers here, "
          f"{weights / 1e9:.2f} GB of weights), paged, flash-decode, "
          f"batch 8, 16 greedy requests (prompts 64-1024, budgets "
          f"32-128): {toks} tokens in {run['wall']:.2f} s = "
          f"{toks / run['wall']:.1f} tok/s; TTFT p50 {p50:.3f} s, p99 "
          f"{p99:.3f} s; {c['decode_steps']} micro-steps in "
          f"{c['dispatches']} chunks ({c['graph_decode_captures']} keys "
          f"captured, {c['graph_decode_replays']} replays, "
          f"{c['graph_capture_s']:.2f} s capturing); flash_decode "
          f"launches {run['launches']} = {cfg.n_layers} x "
          f"{c['decode_steps']}; peak memory {peak / 2**30:.2f} GiB "
          f"[{card_}]")
    # one chunk replayed and one eager on one saved state
    rng = np.random.default_rng(SEED + 201)
    for i in range(8):
        srv.submit(Request(rng.integers(0, cfg.vocab_size, 256).tolist(),
                           64, id=f"probe{i}"))
    srv.step()
    check(srv.n_active == 8, f"20a probe: {srv.n_active} of 8 live")
    s = srv.slots
    k, cols, flat = srv._prepare_chunk()
    leaves = pool_leaves(srv)
    saved = [leaf.clone() for leaf in leaves]
    n = s.pool.n_pages

    def restore():
        for leaf, keep in zip(leaves, saved):
            leaf.copy_(keep)
        sync()

    if ("decode", k, cols) not in srv.graphs.entries:
        srv._run_chunk(flat, k, cols)
        restore()
    want = _decode_chunk(model, s.cache, torch.as_tensor(flat, device=DEVICE),
                         b=s.batch_size, cols=cols, n_steps=k,
                         eos_ids=srv.eos_ids).cpu().numpy()
    want_pool = [leaf[:n].clone() for leaf in leaves]
    restore()
    replays = srv.graphs.calls["decode", "replays"]
    got = srv._run_chunk(flat, k, cols)
    check(srv.graphs.calls["decode", "replays"] == replays + 1,
          "20a: the chunk was not a replay")
    check((got == want).all(), "20a: replayed chunk tokens differ from "
          "the eager chunk's")
    check(all(torch.equal(leaf[:n], w) for leaf, w in zip(leaves,
                                                           want_pool)),
          "20a: replayed chunk pool bytes differ from the eager chunk's")
    del want_pool
    restore()
    chunk_ms = cuda_time_ms(lambda: srv._run_chunk(flat, k, cols), 2,
                            ctx["flush"])
    restore()
    del saved
    while not srv.done:
        srv.step()
    nbytes = sum(p.numel() * p.element_size()
                 for name, p in model.named_parameters()
                 if name != "embedding")
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"phase 20a one chunk ({k} micro-steps, batch 8, 256-token "
          f"prompts) replayed and eager on one saved state: tokens and "
          f"pool bytes bit-equal; replayed {chunk_ms:.1f} ms = "
          f"{chunk_ms / k:.2f} ms a micro-step against a bound of "
          f"{bound:.2f} ms ({nbytes / 1e9:.2f} GB of weights a "
          f"micro-step, every expert of a dropless layer read; at most "
          f"{8 * 1e3 / bound:.0f} tok/s at 8 slots) [{card_}]")
    ctx["moe_serve"] = {"tok_s": toks / run["wall"], "p50": p50, "p99": p99,
                        "peak": peak, "micro_ms": chunk_ms / k,
                        "bound_ms": bound}
    del srv, leaves, restore
    free_card()
    moe_route_gate(ctx, model, specs, run["results"], "20a", False)
    del model
    free_card()
    moe_fp32_gate(ctx, specs)


def free_card() -> None:
    """Collect what cycles hold (a ``Server`` and its graphs) and give
    the cached blocks back."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


class RouteTrace:
    """Forward hooks on a MoE ``Transformer`` that keep, for each forward:
    its tokens and positions, each MoE block's router logits (fp32, as
    the block computes them) and top-k experts, and the final
    activations; every call tagged with ``tag``, a map of batch row to
    request id (rows left out are not kept)."""

    def __init__(self, model):
        import torch

        from tony_tpu_torch.parallel.moe import _top_k, router_logits

        self.calls, self.tag = [], None
        k = model.cfg.moe_top_k

        def start(mod, args, kwargs):
            pos = kwargs.get("positions")
            toks = args[0]
            if pos is None:
                pos = torch.arange(toks.shape[1], device=toks.device)[None]
            elif pos.dim() == 1:
                pos = pos[:, None]
            self.calls.append({"tag": self.tag, "tokens": toks.clone(),
                               "positions": pos.expand_as(toks).clone(),
                               "router": [], "top": [], "final": None})

        def route(mod, args):
            x = args[0]
            logits = router_logits(x.reshape(-1, x.shape[-1]), mod.router)
            self.calls[-1]["router"].append(logits)
            self.calls[-1]["top"].append(
                _top_k(torch.softmax(logits, dim=-1), k)[1].sort(-1).values)

        def final(mod, args, out):
            self.calls[-1]["final"] = out.reshape(-1, out.shape[-1]).clone()

        self.hooks = [model.register_forward_pre_hook(start,
                                                      with_kwargs=True),
                      model.ln_f.register_forward_hook(final)]
        self.hooks += [b.moe.register_forward_pre_hook(route)
                       for b in model.blocks]

    def remove(self) -> None:
        for h in self.hooks:
            h.remove()

    def streams(self, seqs: dict) -> dict:
        """Per request id, over its positions 0..len(seq)-1: router logits
        [layers, n, E], top-k [layers, n, k] and final activations [n, D],
        on the card; every position filled once, at its own token."""
        import torch

        out = {}
        first = next(c for c in self.calls if c["router"])
        layers, e = len(first["router"]), first["router"][0].shape[-1]
        for rid, seq in seqs.items():
            n = len(seq)
            out[rid] = {
                "router": torch.zeros(layers, n, e, device=DEVICE),
                "top": torch.zeros(layers, n, first["top"][0].shape[-1],
                                   dtype=torch.int64, device=DEVICE),
                "final": torch.zeros(n, first["final"].shape[-1],
                                     dtype=first["final"].dtype,
                                     device=DEVICE),
                "seen": torch.zeros(n, dtype=torch.int64, device=DEVICE),
                "seq": torch.tensor(seq, device=DEVICE)}
        for c in self.calls:
            width = c["tokens"].shape[1]
            for row, rid in (c["tag"] or {}).items():
                if rid not in out:
                    continue
                o = out[rid]
                pos = c["positions"][row]
                keep = (pos >= 0) & (pos < len(o["seq"]))
                at = pos[keep]
                flat = torch.arange(row * width, (row + 1) * width,
                                    device=DEVICE)[keep]
                check(bool((c["tokens"][row][keep] == o["seq"][at]).all()),
                      f"route trace: request {rid}'s tokens not at their "
                      "positions")
                o["router"][:, at] = torch.stack(c["router"])[:, flat]
                o["top"][:, at] = torch.stack(c["top"])[:, flat]
                o["final"][at] = c["final"][flat]
                o["seen"][at] += 1
        for rid, o in out.items():
            check(bool((o["seen"] == 1).all()), f"route trace: request "
                  f"{rid}: positions seen other than once")
        return out


def route_compare(model, got: dict, want: dict, held: int) -> dict:
    """One request's trace ``got`` against the plain forward's ``want``
    (``RouteTrace.streams``). A routing difference (the top-k set of
    some layer at some position) changes every later layer at that
    position and, through attention, every later position; before it
    both computations route alike and differ by rounding alone. Held:
    at every position before the first difference, the greedy tokens of
    the final activations agree or part at a near tie of the plain
    forward's logits (the stream's rule); in the first ``held`` layers,
    the router logits agree to ``NEAR_TIE`` x the row's largest |logit|
    at every position that no difference below reaches; with every
    layer held, the first difference is a near tie of the router there
    (its 2nd less 3rd logit within the same tolerance). Returns what was
    seen: ``head``, the first position that differs in some layer, and
    ``lowest``, the lowest layer differing there; the routers' largest
    deviation at each layer over its unreached positions, in
    tolerances."""
    import torch

    flip = (got["top"] != want["top"]).any(dim=-1)  # [layers, n]
    layers, n = flip.shape
    first = [int(f.nonzero()[0]) if bool(f.any()) else n for f in flip]
    per_layer = []
    for layer in range(layers):
        # this layer's router inputs are reached by a difference in any
        # layer below, at or before the position
        clean = min(first[:layer], default=n)
        r_got, r_want = got["router"][layer, :clean], \
            want["router"][layer, :clean]
        per_layer.append(float(((r_got - r_want).abs().amax(-1) / (
            NEAR_TIE * r_want.abs().amax(-1))).max()) if clean else 0.0)
    head = min(first)
    lowest = first.index(head) if head < n else None
    gap_worst = 0.0
    for s in range(0, head, 256):
        with torch.no_grad():
            lg = model.logits(got["final"][s:head][:256].float())
            lw = model.logits(want["final"][s:head][:256].float())
        a, b = lg.argmax(-1), lw.argmax(-1)
        gap = (lw.gather(-1, b[:, None]) - lw.gather(-1, a[:, None]))[:, 0]
        gap_worst = max(gap_worst, float(
            (gap / (NEAR_TIE * lw.abs().amax(-1))).max()))
        del lg, lw
    check(gap_worst <= 1.0, f"before any routing difference the greedy "
          f"tokens part by {gap_worst:.3g}x the near-tie tolerance")
    margin = None
    if lowest is not None:
        r = want["router"][lowest, head].sort(descending=True).values
        margin = float(r[1] - r[2]) / (NEAR_TIE * float(r.abs().max()))
    worst = max(per_layer[:held], default=0.0)
    check(worst <= 1.0, f"the router logits of layers 0-{held - 1} differ "
          f"by {worst:.3g}x the near-tie tolerance where no routing "
          f"difference reaches them")
    if held == layers:
        check(margin is None or margin <= 1.0, f"the first routing "
              f"difference (position {head}, layer {lowest}) is no near "
              f"tie: router margin {margin}x the tolerance")
    return {"flips": int(flip.sum()), "head": head, "lowest": lowest,
            "margin": margin, "gap_worst": gap_worst,
            "per_layer": per_layer}


def moe_route_gate(ctx, model, specs: list, results: dict | None,
                   part: str, tight: bool) -> None:
    """Hold a ``Server``'s streams of ``specs`` to the plain full
    forward. The requests run through a fresh ``Server`` with every
    dispatch eager (the functions the replays record), traced by
    ``RouteTrace``; given ``results`` (a replayed run of the same
    requests), each stream must equal the replayed run's, token for
    token, and is held in its place. Each request's prompt and stream
    then go through the plain forward, traced too, and
    ``route_compare`` holds the two traces (``tight``: every layer's
    router, else the first layer's, whose inputs pass no expert layer).
    Each stream must equal the plain forward's greedy tokens, or
    part at a near tie before the first routing difference, or part at
    or after it. Without ``tight`` (bf16), the plain forward over the
    same tokens padded with zeros (a change of shape only, no server
    code) is traced beside it, and its first routing difference and
    router deviations printed with the server's."""
    import contextlib as ctxlib

    import numpy as np
    import torch

    from tony_tpu_torch.serve import Server

    card_ = ctx["card"]
    t0 = time.perf_counter()
    by_prompt = {tuple(p): i for i, (p, _) in enumerate(specs)}
    srv = Server(model, batch_size=8, eos_id=MIXTRAL_EOS, chunk_steps=8,
                 device=DEVICE)
    srv.graphs, srv._hold = None, ctxlib.nullcontext
    trace = RouteTrace(model)
    prefill, chunk = srv._prefill_suffix, srv._run_chunk

    def tagged(fn, tag):
        def run(*a):
            trace.tag = tag(*a)
            try:
                return fn(*a)
            finally:
                trace.tag = None
        return run

    srv._prefill_suffix = tagged(prefill, lambda slot, p, off: {
        0: by_prompt[tuple(np.asarray(p).tolist())]})
    srv._run_chunk = tagged(chunk, lambda *a: {
        s: live.request.id for s, live in enumerate(srv._live)
        if live is not None})
    try:
        eager = serve_timed(srv, requests(specs))
    finally:
        trace.remove()
    again = eager["results"]
    if results is None:
        results, same = again, None
        reqs = requests(specs)
        check_run(srv, reqs, eager, part)
    else:
        same = sum(again[i].tokens == results[i].tokens
                   and again[i].finish_reason == results[i].finish_reason
                   for i in results)
        check(same == len(results), f"{part}: the eager run's streams "
              f"equal the replayed run's in {same} of {len(results)} "
              "requests")
    seqs = {i: p + results[i].tokens[:-1] for i, (p, _) in enumerate(specs)}
    served = trace.streams(seqs)
    del srv, trace, prefill, chunk
    free_card()  # the eager server's pool (its methods close a cycle)
    plain = RouteTrace(model)
    rows, parts, after = [], [], []

    def traced(i, pad=0):
        plain.calls.clear()
        plain.tag = {0: i}
        with torch.no_grad():
            model(torch.tensor([seqs[i] + [0] * pad], device=DEVICE),
                  return_hidden=True)
        return plain.streams({i: seqs[i]})[i]

    try:
        for i, (prompt, _) in enumerate(specs):
            want = traced(i)
            m, toks = len(prompt), results[i].tokens
            seen = route_compare(model, served[i], want,
                                 len(model.blocks) if tight else 1)
            ctrl = None if tight else route_compare(
                model, traced(i, (len(seqs[i]) // 512 + 1) * 512
                              - len(seqs[i])), want, 0)
            with torch.no_grad():
                lw = model.logits(want["final"][m - 1:].float())
            greedy = lw.argmax(-1).tolist()
            j = next((x for x, (a, b) in enumerate(zip(toks, greedy))
                      if a != b), None)
            if j is not None and m - 1 + j < seen["head"]:
                gap = float(lw[j, greedy[j]] - lw[j, toks[j]])
                tol = NEAR_TIE * float(lw[j].abs().max())
                check(gap <= tol, f"{part} request {i}: the stream parts "
                      f"from the plain forward's at token {j}, before any "
                      f"routing difference, by a logit gap {gap:.4g} > "
                      f"{tol:.4g}")
                parts.append((i, j))
            elif j is not None:
                after.append((i, j, m, seen["head"], seen["lowest"]))
            rows.append((i, m, seen, ctrl))
            del want, lw
            served[i] = None
    finally:
        plain.remove()
    n_req = len(specs)
    differ = [r for r in rows if r[2]["lowest"] is not None]
    margins = sorted(s["margin"] for _, _, s, _ in differ)
    depth = [max(s["per_layer"][k] for _, _, s, _ in rows)
             for k in range(len(rows[0][2]["per_layer"]))]
    print(f"phase {part} the {n_req} streams "
          + ("" if same is None else "again ")
          + f"through a Server with every dispatch eager, traced "
          + (f"({eager['launches']} flash_decode launches)" if same is None
             else f"{same} of {n_req} equal to the replayed run's")
          + f"; against the plain full forward: routing "
          f"differs (the top-2 set of a layer at a position) in "
          f"{len(differ)} of {n_req} requests "
          f"({sum(s['flips'] for _, _, s, _ in rows)} position-layers in "
          f"all, the first inside the prompt in "
          f"{sum(s['head'] < m for _, m, s, _ in differ)}); each first "
          f"difference at a router margin (2nd less 3rd logit) of "
          + (", ".join(f"{x:.3g}" for x in margins) or "none")
          + f" (x the near-tie tolerance{', held' if tight else ''}); "
          f"greedy tokens before it within "
          f"{max(s['gap_worst'] for _, _, s, _ in rows):.3g}x (held); "
          f"router logits where no difference reaches, the largest "
          f"deviation by layer, in tolerances: "
          + " ".join(f"{x:.2f}" for x in depth)
          + (" (all held)" if tight else " (layer 0 held)")
          + f" ({time.perf_counter() - t0:.1f} s) [{card_}]")
    if not tight:
        alike = sum((s["head"], s["lowest"]) == (c["head"], c["lowest"])
                    for _, _, s, c in rows)
        cdepth = [max(c["per_layer"][k] for _, _, _, c in rows)
                  for k in range(len(depth))]
        print(f"phase {part} control, the plain forward over the same "
              f"tokens padded with zeros to the next multiple of 512 (a "
              f"change of shape, no server code) against the plain "
              f"forward: routing differs in "
              f"{sum(c['lowest'] is not None for _, _, _, c in rows)} of "
              f"{n_req} requests, its first difference the server's "
              f"(position and layer) in {alike} of {n_req}; router "
              f"deviation by layer: " + " ".join(f"{x:.2f}" for x in cdepth))
    print(f"phase {part} first routing differences (request: position, of "
          f"prompt length; layer): " + (", ".join(
              f"{i}: {s['head']} of {m}; {s['lowest']}"
              for i, m, s, _ in differ) or "none"))
    print(f"phase {part} streams against the plain forward's greedy "
          f"tokens: {n_req - len(parts) - len(after)} of {n_req} equal, "
          f"{len(parts)} part at a near tie before any routing difference"
          + "".join(f" (request {i} at token {j})" for i, j in parts)
          + f", {len(after)} part at or after the first routing difference"
          + "".join(f" (request {i} at token {j} = position {m + j - 1}; "
                    f"first difference at {h}, layer {lo})"
                    for i, j, m, h, lo in after) + f" [{card_}]")


def moe_fp32_gate(ctx, specs: list) -> None:
    """20a's traffic held tightly: Mixtral-8x7B at full width and
    ``MIXTRAL_FP32_LAYERS`` layers in fp32 (TF32 off), the same 16
    requests through ``moe_route_gate`` with the routers held too (the
    eager dispatches only: bf16 above holds them equal to the
    replays)."""
    import torch

    from tony_tpu_torch.models.transformer import Transformer

    cfg = mixtral_config(n_layers=MIXTRAL_FP32_LAYERS, dtype=torch.float32)
    model = Transformer(cfg, device=DEVICE).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED + 207))
    print(f"phase 20a fp32: full width, {cfg.n_layers} layers, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB of weights "
          f"[{ctx['card']}]")
    moe_route_gate(ctx, model, specs, None, "20a fp32", True)
    del model


def moe_generate(ctx) -> None:
    """20b: Mixtral-8x7B with int8 weights at all 32 layers through
    ``generate`` (batch 8, 512-token prompts, 128 greedy tokens, the
    decode step replayed); the expert-batched kernel held against its
    plain version at the path's decode call (T = 8) and a prefill call of
    one prompt's rows (T = 512), every product of the FFN; its launches
    on the path counted by route."""
    import torch

    import tony_tpu_torch.parallel.moe as moe_mod
    from tony_tpu_torch.models.generate import (_generate_eager, generate,
                                                init_cache)
    from tony_tpu_torch.ops.quant import q8_matmul_experts

    card_ = ctx["card"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # generate's KV cache spans max_seq_len: the prompt and the new tokens
    model = int8_mixtral(32, INT8_PROMPT + INT8_NEW)
    build_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated()
    cfg = model.cfg
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 202)
    prompt = torch.randint(0, cfg.vocab_size, (INT8_BATCH, INT8_PROMPT),
                           device=DEVICE, generator=gen)
    # the FFN's three calls at the path's decode and prefill shapes
    calls = {}
    real = moe_mod.q8_matmul_experts

    def capture(x, w_q, scale, **kw):
        key = ("decode" if x.shape[-2] == INT8_BATCH else "prefill",
               "broadcast" if x.dim() == 2 else "batched", w_q.shape[2])
        if key not in calls:
            rows = x[:MOE_PREFILL_ROWS] if x.dim() == 2 \
                else x[:, :MOE_PREFILL_ROWS]
            calls[key] = (rows.contiguous().clone(), w_q, scale)
        return real(x, w_q, scale, **kw)

    moe_mod.q8_matmul_experts = capture
    try:
        with torch.no_grad():  # a prefill (T = 8 x 512), then a step
            cache = init_cache(model, INT8_BATCH, INT8_PROMPT + 1)
            model(prompt, decode=True, cache=cache)
            model(prompt[:, :1], decode=True, cache=cache)
    finally:
        moe_mod.q8_matmul_experts = real
    del cache
    kern = {}
    for key, (x, w_q, scale) in sorted(calls.items()):
        timed = key[1] == "broadcast"  # wi and wg, [T, D] x [E, D, F]
        m = measure_q8e(ctx, x, w_q, scale, 10 if key[0] == "decode" else 3,
                        timed)
        text = (f"kernel {m['ms'] * 1e3:.1f} us = {m['rate']}, plain "
                f"{m['plain_ms'] * 1e3:.1f} us, _weight_int8pack_mm over "
                f"the experts {m['library_ms'] * 1e3:.1f} us, bound "
                f"{m['bound_ms'] * 1e3:.2f} us ({m['bound_by']})"
                if timed else "held, not timed")
        print(f"phase 20b q8_matmul_experts at the path's {key[0]} call, "
              f"{key[1]} x{tuple(x.shape)} {x.dtype}, w{tuple(w_q.shape)} "
              f"(route {m['route']}, grid {m['grid']} x 8 experts): max abs "
              f"err {m['max_abs_err']:.3g} ({m['of_limit']:.3f} of its "
              f"limit); {text} [{card_}]")
        if timed:
            kern[key[0]] = m
        del x
    check(set(kern) == {"decode", "prefill"}, f"20b: measured {set(kern)}")
    ctx["moe_kernels"] = kern
    del calls
    torch.cuda.empty_cache()
    generate(model, prompt[:, :16], max_new_tokens=2)  # captures the step
    q8_matmul_experts.launches = 0
    q8_matmul_experts.route_launches[:] = [0, 0, 0]
    sync()
    t0 = time.perf_counter()
    out = generate(model, prompt, max_new_tokens=INT8_NEW)
    sync()
    wall = time.perf_counter() - t0
    launches = q8_matmul_experts.launches
    routes = list(q8_matmul_experts.route_launches)
    c = model.graphs.counters(("generate",))
    check(c["generate_captures"] == 1
          and c["generate_replays"] == INT8_NEW - 1,
          f"20b generate: {c} (every step after the warm-up's first must "
          "be a replay)")
    per = 3 * cfg.n_layers
    check(launches == per * INT8_NEW
          and routes == [per * (INT8_NEW - 1), per, 0],
          f"20b: q8_matmul_experts launched {launches} times, by route "
          f"{routes}; expected 3 x {cfg.n_layers} x ({INT8_NEW - 1} "
          "replayed decode steps + 1 prefill)")
    ctx["moe_q8e_launches"] = routes
    check(out.shape == (INT8_BATCH, INT8_NEW)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"20b generate gave {tuple(out.shape)} or ids out of range")
    with torch.no_grad():
        eager = _generate_eager(model, prompt, max_new_tokens=8,
                                pick=functools.partial(torch.argmax, dim=-1),
                                eos_ids=())
    check(torch.equal(out[:, :8], eager),
          "20b: replayed generate's first 8 tokens differ from eager")
    cache = init_cache(model, INT8_BATCH, INT8_PROMPT + INT8_NEW)
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        model(prompt, decode=True, cache=cache)
    sync()
    prefill = time.perf_counter() - t0
    del cache
    peak = torch.cuda.max_memory_allocated()
    step_ms = (wall - prefill) / (INT8_NEW - 1) * 1e3
    nbytes = sum(t.numel() * t.element_size()
                 for name, t in model.state_dict().items()
                 if name != "embedding")
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"phase 20b generate Mixtral-8x7B int8 weights (bf16 "
          f"activations), 32 layers ({weights / 1e9:.2f} GB on the card, "
          f"built layer by layer in {build_s:.1f} s), batch {INT8_BATCH}, "
          f"{INT8_PROMPT}-token prompts, {INT8_NEW} greedy tokens, steps "
          f"replayed: {wall:.3f} s = {INT8_BATCH * INT8_NEW / wall:.1f} "
          f"tok/s; prefill {prefill * 1e3:.1f} ms, then {step_ms:.2f} ms a "
          f"decode step against a bound of {bound:.2f} ms "
          f"({nbytes / 1e9:.2f} GB a step) = "
          f"{INT8_BATCH * 1e3 / step_ms:.1f} decode tok/s; the first 8 "
          f"tokens equal eager generate's; q8_matmul_experts launches "
          f"{launches} by route {routes}; peak memory "
          f"{peak / 2**30:.2f} GiB; no bf16 dense-FFN yardstick (not "
          f"measured) [{card_}]")
    ctx["moe_generate"] = {"tok_s": INT8_BATCH * INT8_NEW / wall,
                           "step_ms": step_ms, "bound_ms": bound,
                           "peak": peak}
    del model, out


def moe_train(ctx) -> None:
    """20c: one block at Mixtral-8x7B's width, routed (capacity 1.25, 8
    SwiGLU experts, top-2), flash attention, remat ``attn_saved``, bf16
    compute over fp32 masters with fused AdamW, batch 2 x 2048, 4 steps
    with the step captured whole; losses fall and the aux loss is
    finite; then phase 8's gate: 3 steps replayed and 3 eager from one
    saved state, bit-equal."""
    import torch

    from tony_tpu_torch.models.transformer import Transformer, moe_aux_loss
    from tony_tpu_torch.ops import adamw, attention
    from tony_tpu_torch.ops.xent import chunked_cross_entropy
    from tony_tpu_torch.train import FusedAdamW, Trainer

    card_ = ctx["card"]
    cfg = mixtral_config(n_layers=1, max_seq_len=MOE_TRAIN_SEQ,
                         dtype=torch.bfloat16, attention_backend="pallas",
                         remat=True, remat_policy="attn_saved",
                         moe_dropless=False, moe_capacity_factor=1.25)
    model = Transformer(cfg, device=DEVICE).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED + 203))
    cdt = torch.bfloat16

    def apply_fn(m, batch):
        losses = []
        hidden = m(batch["tokens"], return_hidden=True, losses=losses)
        return chunked_cross_entropy(
            hidden[:, :-1], m.lm_head, batch["tokens"][:, 1:],
            chunk_size=XENT_CHUNK_MOE, compute_dtype=cdt) \
            + moe_aux_loss(losses)

    trainer = Trainer(model, apply_fn, FusedAdamW(3e-4),
                      compute_dtype=cdt)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 204)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (
        MOE_TRAIN_BATCH, MOE_TRAIN_SEQ), device=DEVICE, generator=gen)}
    counters = (attention.flash_attention_fwd,
                attention.flash_attention_bwd_dq,
                attention.flash_attention_bwd_dkv, adamw.fused_adamw_update)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state()
    losses = []
    sync()
    t0 = time.perf_counter()
    for _ in range(MOE_TRAIN_STEPS):
        state, m = trainer.step(state, batch)
        losses.append(m["loss"])
    sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = [c.launches for c in counters]
    losses = torch.stack(losses).float().cpu().tolist()
    g = trainer.graphs.counters(("train_step",))
    check(g["train_step_captures"] == 1
          and g["train_step_replays"] == MOE_TRAIN_STEPS - 1,
          f"20c: {g} (the first step captured, the rest replays)")
    check(launches == [MOE_TRAIN_STEPS] * 4,
          f"20c: launches fwd/dq/dkv/adamw {launches}, expected "
          f"{MOE_TRAIN_STEPS} each (one layer, attn_saved)")
    check(all(x == x for x in losses) and losses[-1] < losses[0],
          f"20c losses {losses} not finite and falling")
    aux = []
    with torch.no_grad():
        model(batch["tokens"], losses=aux)
    aux_v = float(moe_aux_loss(aux, weight=1.0))
    check(len(aux) == 1 and aux_v == aux_v and abs(aux_v) < 1e6,
          f"20c aux loss {aux_v} ({len(aux)} values)")
    ctx["moe_train_launches"] = launches
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase 20c train one Mixtral-8x7B block ({n_params} params; "
          f"routed, capacity 1.25, 8 SwiGLU experts, top-2), flash "
          f"attention, remat attn_saved, bf16 compute over fp32 masters, "
          f"fused AdamW, batch {MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ}, "
          f"{MOE_TRAIN_STEPS} steps captured whole (1 capture, "
          f"{g['train_step_replays']} replays, {g['capture_s']:.2f} s "
          f"capturing): {wall / MOE_TRAIN_STEPS * 1e3:.1f} ms a step "
          f"with the capture; losses {[round(x, 4) for x in losses]}; aux "
          f"loss {aux_v:.4f}; launches fwd/dq/dkv/adamw {launches}; peak "
          f"memory {peak / 2**30:.2f} GiB [{card_}]")
    state, gate = train_replay_gate(ctx, trainer, state, [batch] * 3,
                                    counters, [1, 1, 1, 1], tag="phase 20c")
    for how in ("replayed", "eager"):
        print(f"phase 20c {how}: {gate['step_s'][how] * 1e3:.1f} ms a "
              f"step, peak {gate['peak'][how]:.2f} GiB, host share "
              f"{gate['probe'][how]['host']} [{card_}]")
    ctx["moe_train"] = {"step_ms": gate["step_s"]["replayed"] * 1e3,
                        "eager_ms": gate["step_s"]["eager"] * 1e3,
                        "peak": peak}
    del trainer, state, model, gate


MOE_CLI_HF = {  # 20d: Mixtral's shape at test widths
    "model_type": "mixtral", "architectures": ["MixtralForCausalLM"],
    "hidden_size": 256, "intermediate_size": 512, "num_hidden_layers": 2,
    "num_attention_heads": 8, "num_key_value_heads": 2,
    "num_local_experts": 4, "num_experts_per_tok": 2, "vocab_size": 1024,
    "hidden_act": "silu", "rope_theta": 1e6, "rms_norm_eps": 1e-5,
    "sliding_window": None, "tie_word_embeddings": False,
    "max_position_embeddings": 512, "eos_token_id": 2,
}


def export_mixtral(model, hf: dict) -> str:
    """``model`` (a Mixtral) as a checkpoint directory under build/ in
    the Hugging Face names, fp32, as two shards and an index; the caller
    removes it."""
    from tony_tpu_torch.models.hf import write_safetensors

    sd = {k: v.float() for k, v in model.state_dict().items()}
    out = {"model.embed_tokens.weight": sd["embedding"],
           "model.norm.weight": sd["ln_f.scale"],
           "lm_head.weight": sd["lm_head"]}
    names = {"input_layernorm.weight": "ln1.scale",
             "post_attention_layernorm.weight": "ln2.scale",
             "self_attn.o_proj.weight": "attn.o.weight"}
    for p in "qkv":
        names[f"self_attn.{p}_proj.weight"] = f"attn.{p}.weight"
    for i in range(model.cfg.n_layers):
        pre, src = f"model.layers.{i}.", f"blocks.{i}."
        for dst, s in names.items():
            out[pre + dst] = sd[src + s]
        moe = pre + "block_sparse_moe."
        out[moe + "gate.weight"] = sd[src + "moe.router"].t()
        for x in range(model.cfg.moe_num_experts):
            for w, s in (("w1", "wg"), ("w3", "wi"), ("w2", "wo")):
                out[f"{moe}experts.{x}.{w}.weight"] = \
                    sd[f"{src}moe.{s}"][x].t()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="smoke_mixtral_",
                            dir=os.path.join(ROOT, "build"))
    with open(os.path.join(ckpt, "config.json"), "w") as fh:
        json.dump(hf, fh)
    names = sorted(out)
    weight_map = {}
    for j, part in enumerate((names[:len(names) // 2],
                              names[len(names) // 2:])):
        fname = f"model-{j + 1:05d}-of-00002.safetensors"
        write_safetensors({k: out[k] for k in part},
                          os.path.join(ckpt, fname))
        weight_map.update(dict.fromkeys(part, fname))
    with open(os.path.join(ckpt, "model.safetensors.index.json"), "w") as fh:
        json.dump({"metadata": {}, "weight_map": weight_map}, fh)
    return ckpt


def moe_cli(ctx) -> None:
    """20d: a 2-layer Mixtral at test widths, written as two shards and
    an index, through ``cli.generate --serve``, ``cli.generate --int8``
    (tokens equal to ``generate`` over the reader's int8 model) and
    ``cli.score --int8`` (within 5% of the fp32 score)."""
    import numpy as np
    import torch

    from tony_tpu_torch.cli import generate as cli
    from tony_tpu_torch.cli import score
    from tony_tpu_torch.models.generate import generate
    from tony_tpu_torch.models.hf import load_hf_dir, mixtral_config as mc
    from tony_tpu_torch.models.transformer import Transformer
    from tony_tpu_torch.ops.quant import q8_matmul_experts

    def run(main, argv, stdin=""):
        out = io.StringIO()
        old = sys.stdin
        sys.stdin = io.StringIO(stdin)
        try:
            with contextlib.redirect_stdout(out):
                rc = main(argv + ["--device", DEVICE])
        finally:
            sys.stdin = old
        return rc, out.getvalue().strip().splitlines()

    model = Transformer(mc(MOE_CLI_HF), device=DEVICE).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED + 205))
    ckpt = export_mixtral(model, MOE_CLI_HF)
    del model
    try:
        rng = np.random.default_rng(SEED + 206)
        prompts = [rng.integers(3, 1024, n).tolist() for n in (12, 12, 40)]
        lines = [json.dumps({"id": f"r{i}", "token_ids": p,
                             "max_new_tokens": 16})
                 for i, p in enumerate(prompts)]
        rc, out = run(cli.main, ["--model", ckpt, "--serve", "--serve-batch",
                                 "2"], "\n".join(lines) + "\n")
        check(rc == 0 and len(out) == 3, f"20d --serve: exit {rc}, "
              f"{len(out)} lines")
        ids = [a for p in prompts for a in ("--token-ids",
                                            ",".join(map(str, p)))]
        q8_matmul_experts.launches = 0
        rc, out = run(cli.main, ["--model", ckpt, *ids, "--int8",
                                 "--max-new-tokens", "8"])
        check(rc == 0 and len(out) == 3, f"20d --int8: exit {rc}")
        cli_launches = q8_matmul_experts.launches
        check(cli_launches > 0, "20d --int8 launched no q8_matmul_experts")
        qmodel, _ = load_hf_dir(ckpt, device=DEVICE, int8=True)
        # the CLI decodes prompts of one length as one batch: so here
        want = {}
        for n in sorted({len(p) for p in prompts}):
            group = [p for p in prompts if len(p) == n]
            rows = generate(qmodel, torch.tensor(group, device=DEVICE),
                            max_new_tokens=8, eos_id=2).tolist()
            want.update({tuple(p): r for p, r in zip(group, rows)})
        for p, line in zip(prompts, out):
            got = [int(t) for t in line.split(",")][len(p):]
            w = want[tuple(p)]
            check(got == w[:len(got)] and len(got) >= 1,
                  f"20d --int8 tokens {got} against generate's {w}")
        del qmodel
        seqs = ["--token-ids", ",".join(map(str, prompts[2]))]
        rc, q8_lines = run(score.main, ["--model", ckpt, *seqs, "--int8"])
        rc2, fp_lines = run(score.main, ["--model", ckpt, *seqs])
        check(rc == rc2 == 0, f"20d score: exits {rc}, {rc2}")

        def nll(lines_):
            fields = dict(f.split("=") for f in lines_[-1].split()[1:])
            return float(fields["nll/token"])

        nq, nf = nll(q8_lines), nll(fp_lines)
        check(abs(nq - nf) <= 0.05 * nf, f"20d int8 nll {nq} not within 5% "
              f"of fp32 {nf}")
        print(f"phase 20d CLIs over a 2-layer Mixtral checkpoint at test "
              f"widths (two shards and an index): --serve answered 3 "
              f"requests; --int8 answered 3 prompts, tokens equal to "
              f"generate over the reader's int8 model "
              f"(q8_matmul_experts launches {cli_launches}); score "
              f"nll/token int8 {nq:.4f} vs fp32 {nf:.4f} [{ctx['card']}]")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def moe_kernel_lines(ctx) -> list[dict]:
    """The expert-batched q8_matmul at 20b's decode call (T = 8) and a
    prefill call (T = 512), launches from 20b's generate by route."""
    lines = []
    for i, call in ((0, "decode"), (1, "prefill")):
        m = ctx["moe_kernels"][call]
        lines.append({"name": f"q8_matmul_experts_{call}", "route": "cuda",
                      "source": "tony_tpu_torch/csrc/q8_matmul.cu",
                      "replaces": "tony_tpu/ops/quant.py:42",
                      "launches": ctx["moe_q8e_launches"][i],
                      "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                      "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                      "bound_by": m["bound_by"],
                      "library_ms": m["library_ms"]})
    return lines


# ------------------------------------------------------------ the zoo

# 21: four published configs (config.json, the keys the port reads),
# random bf16 weights from the seed, full width and depth
ZOO = (
    ("GPT-2 XL", "https://huggingface.co/openai-community/gpt2-xl", {
        "model_type": "gpt2", "architectures": ["GPT2LMHeadModel"],
        "n_embd": 1600, "n_layer": 48, "n_head": 25, "n_positions": 1024,
        "n_ctx": 1024, "vocab_size": 50257,
        "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5,
        "bos_token_id": 50256, "eos_token_id": 50256}),
    ("Pythia-1.4B", "https://huggingface.co/EleutherAI/pythia-1.4b", {
        "model_type": "gpt_neox", "architectures": ["GPTNeoXForCausalLM"],
        "hidden_size": 2048, "num_hidden_layers": 24,
        "num_attention_heads": 16, "intermediate_size": 8192,
        "rotary_pct": 0.25, "rotary_emb_base": 10000,
        "max_position_embeddings": 2048, "vocab_size": 50304,
        "use_parallel_residual": True, "tie_word_embeddings": False,
        "hidden_act": "gelu", "layer_norm_eps": 1e-5, "bos_token_id": 0,
        "eos_token_id": 0}),
    ("Phi-2", "https://huggingface.co/microsoft/phi-2", {
        "model_type": "phi", "architectures": ["PhiForCausalLM"],
        "hidden_size": 2560, "num_hidden_layers": 32,
        "num_attention_heads": 32, "num_key_value_heads": 32,
        "intermediate_size": 10240, "partial_rotary_factor": 0.4,
        "max_position_embeddings": 2048, "vocab_size": 51200,
        "hidden_act": "gelu_new", "layer_norm_eps": 1e-5,
        "rope_theta": 10000.0, "qk_layernorm": False,
        "tie_word_embeddings": False, "bos_token_id": 50256,
        "eos_token_id": 50256}),
    ("Gemma-2B", "https://huggingface.co/google/gemma-2b", {
        "model_type": "gemma", "architectures": ["GemmaForCausalLM"],
        "hidden_size": 2048, "num_hidden_layers": 18,
        "num_attention_heads": 8, "num_key_value_heads": 1,
        "head_dim": 256, "intermediate_size": 16384, "vocab_size": 256000,
        "max_position_embeddings": 8192, "hidden_act": "gelu",
        "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "attention_bias": False,
        "bos_token_id": 2, "eos_token_id": 1, "pad_token_id": 0}),
)
ZOO_CLI = "Gemma-2B"  # 21e: the family with the most knobs, at 2 layers


def zoo_config(hf: dict, **overrides):
    """The port's config of a zoo ``config.json`` through its family's
    reader: bf16, flash-decode, ``max_seq_len`` the published one capped
    at ``SERVE_MAX_LEN`` (GPT-2's own cap is its ``n_positions``)."""
    import torch

    from tony_tpu_torch.models.hf import FAMILIES

    make = FAMILIES[hf["model_type"]][0]
    pub = hf.get("max_position_embeddings") or hf["n_positions"]
    kw = dict(max_seq_len=min(pub, SERVE_MAX_LEN), dtype=torch.bfloat16,
              decode_attention="flash")
    kw.update(overrides)
    return make(hf, **kw)


def zoo_state_dict(kind: str, cfg, gen, device) -> dict:
    """A checkpoint's tensors under its own names (``models.hf.
    hf_shapes``), bf16, drawn from ``gen``: norm scales 1 (0 for
    Gemma's 1 + weight form), every other tensor N(0, 0.02)."""
    import torch

    from tony_tpu_torch.models.hf import hf_shapes

    out = {}
    for name, shape in hf_shapes(kind, cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if len(shape) == 1 and leaf == "weight":  # a norm's scale
            t = torch.full(shape, 0.0 if cfg.norm_unit_offset else 1.0,
                           dtype=torch.bfloat16, device=device)
        else:
            t = (0.02 * torch.randn(shape, generator=gen, device=device)
                 ).bfloat16()
        out[name] = t
    return out


def zoo_model(kind: str, cfg, seed: int):
    """(model, checkpoint parameter count): the checkpoint drawn on the
    card under its own names, mapped by the family's converter
    (``Family.convert``) and loaded into a ``Transformer`` built on the
    meta device."""
    import torch

    from tony_tpu_torch.models.hf import FAMILIES
    from tony_tpu_torch.models.transformer import Transformer

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    sd = zoo_state_dict(kind, cfg, gen, DEVICE)
    n_params = sum(t.numel() for t in sd.values())
    model = Transformer(cfg, device="meta")
    model.to_empty(device=DEVICE)
    model.load_state_dict(FAMILIES[kind][1].convert(sd, cfg), strict=True)
    del sd
    return model.eval(), n_params


def zoo_specs(rng, vocab: int) -> list:
    """21's 8 requests as (prompt, budget): prompts of 64-512 tokens,
    budgets 32-64."""
    return [(rng.integers(0, vocab, int(rng.integers(64, 513))).tolist(),
             int(rng.integers(32, 65))) for _ in range(8)]


def plain_greedy_check(model, specs, results, part: str) -> list:
    """Each stream against greedy decoding by the plain full forward
    (teacher-forced over the stream's own tokens): equal, or parting
    first at a near tie. Returns the partings as ``near_ties`` does."""
    import torch

    ties = []
    for i, (prompt, _) in enumerate(specs):
        got = results[i].tokens
        seq = torch.tensor([prompt + got[:-1]], device=DEVICE)
        with torch.no_grad():
            hidden = model(seq, return_hidden=True)
            want = model.logits(hidden[0, len(prompt) - 1:]).argmax(
                dim=-1).tolist()
        del hidden
        j = next((n for n, (a, w) in enumerate(zip(got, want)) if a != w),
                 None)
        if j is not None:
            tie = parting(model, prompt, got, got[:j] + [want[j]],
                          f"{part} request {i} against the plain forward")
            ties.append((i, *tie))
    return ties


def zoo_decode_call(ctx, cfg) -> dict:
    """flash-decode at the model's decode call, B = 8, S = 1024, every
    row at the full length, bf16: held to ``decode_tolerance`` and timed
    beside its plain version, SDPA and its bound."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 210)
    b, s, h, kvh, d = 8, 1024, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q = torch.randn(b, h, d, device=DEVICE, generator=gen).bfloat16()
    k = torch.randn(b, s, kvh, d, device=DEVICE, generator=gen).bfloat16()
    v = torch.randn(b, s, kvh, d, device=DEVICE, generator=gen).bfloat16()
    length = torch.full((b,), s, dtype=torch.int32, device=DEVICE)
    m = measure_decode(q, k, v, length, 0, None, None, ctx["flush"])
    del q, k, v
    return m


def phase_zoo(ctx) -> None:
    """Phase 21: GPT-2 XL, Pythia-1.4B, Phi-2 and Gemma-2B at their
    published configs, through ``Server``; then 21e, the CLIs over a
    2-layer Gemma-2B checkpoint directory."""
    import numpy as np
    import torch

    from tony_tpu_torch.ops.decode import _kernel_route

    card_ = ctx["card"]
    ctx["zoo"] = {}
    for j, (name, url, hf) in enumerate(ZOO):
        t0 = time.perf_counter()
        kind = hf["model_type"]
        cfg = zoo_config(hf)
        free_card()
        torch.cuda.reset_peak_memory_stats()
        model, n_params = zoo_model(kind, cfg, SEED + 21 + j)
        weights = sum(p.numel() * p.element_size()
                      for p in model.parameters())
        eos = hf["eos_token_id"]
        srv = zoo_server(model, eos)
        check(srv.paged, f"21 {name}: not served paged")
        specs = zoo_specs(np.random.default_rng(SEED + 21 + j),
                          cfg.vocab_size)
        reqs = requests(specs)
        run = serve_timed(srv, reqs)
        c = check_run(srv, reqs, run, f"21 {name}")
        peak = torch.cuda.max_memory_allocated()
        toks = sum(len(r.tokens) for r in run["results"].values())
        p50, p99 = percentiles(run["first"][r.id] for r in reqs)
        tc = _kernel_route(torch.bfloat16, torch.bfloat16, cfg.head_dim) == 1
        form = "MHA" if cfg.kv_heads == cfg.n_heads else (
            f"GQA {cfg.n_heads}/{cfg.kv_heads}")
        route = f"{'tensor cores' if tc else 'SIMT'}, {form}"
        del srv
        free_card()
        ties = plain_greedy_check(model, specs, run["results"], f"21 {name}")
        m = zoo_decode_call(ctx, cfg)
        check(m["route"] == ("tensor cores" if tc else "SIMT"),
              f"21 {name}: the decode call took the {m['route']} route")
        ctx["zoo"][name] = {"launches": run["launches"], "call": m,
                            "route": route, "tok_s": toks / run["wall"],
                            "D": cfg.head_dim, "form": form,
                            "H": cfg.n_heads, "KVH": cfg.kv_heads}
        print(f"phase 21 {name} ({url}; {kind}, {cfg.n_layers} layers, "
              f"d {cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads of "
              f"{cfg.head_dim}, max_seq_len {cfg.max_seq_len}): "
              f"{n_params} parameters in the checkpoint, drawn under its "
              f"own names and mapped by the port's reader, "
              f"{weights / 1e9:.2f} GB of weights on the card (embeddings "
              f"fp32); paged, bf16, batch 8, 8 greedy requests (prompts "
              f"64-512, budgets 32-64): {toks} tokens in "
              f"{run['wall']:.2f} s = {toks / run['wall']:.1f} tok/s; "
              f"TTFT p50 {p50:.3f} s, p99 {p99:.3f} s; "
              f"{c['decode_steps']} micro-steps in {c['dispatches']} chunks "
              f"({c['graph_decode_captures']} keys captured, "
              f"{c['graph_decode_replays']} replays, "
              f"{c['graph_capture_s']:.2f} s capturing); flash_decode "
              f"({route}) launches {run['launches']} = {cfg.n_layers} x "
              f"{c['decode_steps']}, replays included; peak memory "
              f"{peak / 2**30:.2f} GiB; against the plain forward: "
              f"{ties_text(ties, len(specs))} [{card_}]")
        print(f"phase 21 {name} flash_decode at B=8 H={cfg.n_heads} "
              f"KVH={cfg.kv_heads} D={cfg.head_dim} S=1024 bf16 "
              f"({m['route']}, {m['nsplit']} split(s)): max abs err "
              f"{m['max_abs_err']:.3g} (tol {m['rtol']:.3g}*|want| + "
              f"{m['atol']:.3g}, worst excess {m['excess']:.3g}); kernel "
              f"{m['ms'] * 1e3:.1f} us ({m['bound_ms'] / m['ms']:.3f} of "
              f"the bound), plain {m['plain_ms'] * 1e3:.1f} us, sdpa "
              f"{m['library_ms'] * 1e3:.1f} us, bound "
              f"{m['bound_ms'] * 1e3:.2f} us ({m['bound_by']}); "
              f"{time.perf_counter() - t0:.1f} s for the model [{card_}]")
        del model
        free_card()
    by_route: dict = {}
    for z in ctx["zoo"].values():
        by_route[z["route"]] = by_route.get(z["route"], 0) + z["launches"]
    print("phase 21 flash_decode launches by route: " + ", ".join(
        f"{r} {n}" for r, n in by_route.items()) + f" [{card_}]")
    zoo_cli(ctx)


def zoo_server(model, eos):
    """21's serving configuration: batch 8, paged, chunks of up to 8
    micro-steps, no prefix store, the model's end-of-text id."""
    from tony_tpu_torch.serve import Server

    return Server(model, batch_size=8, eos_id=eos, chunk_steps=8,
                  paged=True, device=DEVICE)


def export_zoo(kind: str, hf: dict, cfg, seed: int) -> str:
    """A 2-layer checkpoint directory of a zoo config at full width under
    build/: config.json and model.safetensors, bf16 under the
    checkpoint's own names; the caller removes it."""
    import torch

    from tony_tpu_torch.models.hf import write_safetensors

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    sd = {k: v.cpu() for k, v in zoo_state_dict(kind, cfg, gen,
                                                DEVICE).items()}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="smoke_zoo_",
                            dir=os.path.join(ROOT, "build"))
    with open(os.path.join(ckpt, "config.json"), "w") as fh:
        json.dump(hf, fh)
    write_safetensors(sd, os.path.join(ckpt, "model.safetensors"))
    return ckpt


def zoo_cli(ctx) -> None:
    """21e: ``ZOO_CLI`` at 2 layers and full width as a checkpoint
    directory: ``cli.generate --serve`` from a pipe in bf16 (checked
    responses) and in fp32 (token-exact to a ``Server`` over the
    reader's fp32 model), and ``cli.score`` in fp32 and bf16 (finite,
    within 5% of each other)."""
    import math

    import numpy as np
    import torch

    from tony_tpu_torch.cli import score
    from tony_tpu_torch.models.hf import load_hf_dir
    from tony_tpu_torch.serve import Request, Server

    name, url, hf = next(z for z in ZOO if z[0] == ZOO_CLI)
    hf = dict(hf, num_hidden_layers=2)
    cfg = zoo_config(hf)
    ckpt = export_zoo(hf["model_type"], hf, cfg, SEED + 215)
    try:
        rng = np.random.default_rng(SEED + 216)
        lines = [{"id": f"r{i}", "token_ids": rng.integers(
                     3, hf["vocab_size"], n).tolist(), "max_new_tokens": m}
                 for i, (n, m) in enumerate(((40, 12), (300, 20), (5, 1),
                                             (700, 8)))]
        serve_cli(ckpt, lines, "--dtype", "bf16")
        got = serve_cli(ckpt, lines, "--dtype", "fp32")
        model, _ = load_hf_dir(ckpt, device=DEVICE, decode_attention="flash")
        srv = Server(model, batch_size=4, eos_id=hf["eos_token_id"],
                     paged=True, kv_pages=128, prefix_cache_mb=64.0,
                     device=DEVICE)
        reqs = [Request(x["token_ids"], x["max_new_tokens"], id=x["id"])
                for x in lines]
        run = serve_timed(srv, reqs)
        for x in lines:
            toks = run["results"][x["id"]].tokens
            stop = [i for i, t in enumerate(toks) if t in srv.eos_ids]
            want = x["token_ids"] + toks[:stop[0] if stop else len(toks)]
            check(got[x["id"]]["token_ids"] == want,
                  f"21e {x['id']}: cli --serve fp32 {got[x['id']]} against "
                  f"one Server's {want}")
        del srv, model
        free_card()

        def nll(dtype):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = score.main(["--model", ckpt, "--token-ids",
                                 ",".join(map(str, lines[3]["token_ids"])),
                                 "--dtype", dtype, "--device", DEVICE])
            check(rc == 0, f"21e score --dtype {dtype}: exit {rc}")
            last = out.getvalue().strip().splitlines()[-1]
            return float(dict(f.split("=") for f in
                              last.split()[1:])["nll/token"])

        n32, n16 = nll("fp32"), nll("bf16")
        check(math.isfinite(n32) and abs(n16 - n32) <= 0.05 * n32,
              f"21e score: bf16 nll/token {n16} not within 5% of fp32 {n32}")
        size = os.path.getsize(os.path.join(ckpt, "model.safetensors"))
        print(f"phase 21e CLIs over a 2-layer {name} checkpoint at full "
              f"width ({size / 1e9:.2f} GB): --serve answered "
              f"{len(lines)} requests in bf16, and "
              f"in fp32 token-exact to one Server over the reader's model; "
              f"score nll/token fp32 {n32:.4f}, bf16 {n16:.4f} "
              f"[{ctx['card']}]")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def zoo_kernel_lines(ctx) -> list[dict]:
    """flash-decode at each zoo model's decode call (B = 8, S = 1024),
    with the launches of that model's serving run."""
    lines = []
    for name, z in ctx["zoo"].items():
        m = z["call"]
        mha = z["form"] == "MHA"
        lines.append({
            "name": "flash_decode_" + name.lower().replace(" ", "_")
                    .replace("-", "_").replace(".", "_"),
            "route": "cuda", "source": "tony_tpu_torch/csrc/flash_decode.cu",
            "replaces": "tony_tpu/ops/decode.py:" + ("146" if mha else "70"),
            "launches": z["launches"], "kernel_route": z["route"],
            "shape": f"B=8 H={z['H']} KVH={z['KVH']} D={z['D']} S=1024",
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"]})
    return lines

# ------------------------------------------------------------ scan (22)

SCAN_ATTN_LEN, SCAN_ATTN_BLOCK = 16384, 512  # 22c's blocked call
SCAN_FWD_LEN = 8192                          # 22c's model forward


def scanned_qwen(cfg):
    """A ``scan_layers`` Qwen2.5-1.5B holding phase 4's draw (the
    unscanned model from ``SEED``), stacked."""
    import torch

    from tony_tpu_torch.models.convert import stack_layers
    from tony_tpu_torch.models.transformer import Transformer

    flat = Transformer(dataclasses.replace(cfg, scan_layers=False),
                       device=DEVICE).init_weights(
        torch.Generator(device=DEVICE).manual_seed(SEED))
    model = Transformer(cfg, device=DEVICE)
    model.load_state_dict(stack_layers(flat.state_dict(), cfg.n_layers))
    return model


def first_layer_parting(model, prompt) -> str:
    """Where a scanned model's prefill first differs from the unscanned
    model's on the same weights: each layer's output of a paged
    prefill of ``prompt`` through both, compared bit for bit."""
    import torch

    from tony_tpu_torch.models.convert import unstack_layers
    from tony_tpu_torch.models.generate import multi_decode_step
    from tony_tpu_torch.models.transformer import Transformer
    from tony_tpu_torch.serve.slots import paged_cache

    cfg = model.cfg
    flat = Transformer(dataclasses.replace(cfg, scan_layers=False),
                       device=DEVICE)
    flat.load_state_dict(unstack_layers(model.state_dict()))
    n, ps = len(prompt), 64
    pages = -(-n // ps)
    window = torch.tensor([prompt], device=DEVICE)
    pos = torch.arange(n, device=DEVICE)[None]
    table = torch.arange(pages, device=DEVICE)[None]
    outs = {}
    for name, m, mods in (("scan", model, [model.layers.block]),
                          ("flat", flat, list(flat.blocks))):
        seen = []
        hooks = [mod.register_forward_hook(
            lambda _m, _a, out: seen.append(out.clone())) for mod in mods]
        try:
            multi_decode_step(m, paged_cache(m, pages, ps), window, pos,
                              table)
        finally:
            for h in hooks:
                h.remove()
        outs[name] = seen
    for i, (a, b) in enumerate(zip(outs["scan"], outs["flat"])):
        if not torch.equal(a, b):
            return (f"layer {i} first differs (max abs "
                    f"{(a.float() - b.float()).abs().max().item():.3g})")
    return "no layer differs in the prefill"


def phase_scan(ctx) -> None:
    ctx["scan"] = {}
    scan_serve(ctx)
    free_card()
    scan_train(ctx)
    free_card()
    scan_attention(ctx)
    free_card()


def scan_serve(ctx) -> None:
    """22a: phase 4's traffic through a scanned model."""
    import torch

    cfg = qwen_config(dtype=torch.bfloat16, scan_layers=True)
    model = scanned_qwen(cfg)
    srv = serve_server(model)
    four = ctx["serve4"]
    reqs = requests(four["specs"])
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 30
    run = serve_timed(srv, reqs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    c = check_run(srv, reqs, run, "22a")
    differ = [r.id for r in reqs if run["results"][r.id].tokens
              != four["results"][r.id].tokens]
    if differ:
        where = first_layer_parting(model, reqs[differ[0]].prompt)
        check(False, f"22a: {len(differ)} of {len(reqs)} streams differ "
              f"from phase 4's (first: request {differ[0]}; {where})")
    gen_tokens = sum(len(res.tokens) for res in run["results"].values())
    p50, p99 = percentiles(run["first"][r.id] for r in reqs)
    rate = gen_tokens / run["wall"]
    print(f"phase 22a serve scanned Qwen2.5-1.5B bf16 {cfg.n_layers} "
          f"layers stacked, phase 4's 24 requests: all {len(reqs)} streams "
          f"equal phase 4's token for token; {gen_tokens} tokens in "
          f"{run['wall']:.2f} s = {rate:.1f} tok/s (phase 4 "
          f"{four['rate']:.1f}); TTFT p50 {p50:.3f} s, p99 {p99:.3f} s "
          f"(phase 4 {four['ttft'][0]:.3f}, {four['ttft'][1]:.3f}); peak "
          f"memory {peak:.2f} GiB, {peak - base:.2f} above the "
          f"{base:.2f} resident at the start (phase 4 "
          f"{four['peak_gib']:.2f}, {four['peak_gib'] - four['base_gib']:.2f}"
          f" above {four['base_gib']:.2f}); "
          f"flash_decode launches {run['launches']} = {cfg.n_layers} x "
          f"{c['decode_steps']}; {c['graph_decode_captures']} chunk keys "
          f"captured, {c['graph_decode_replays']} replays, "
          f"{c['graph_capture_s']:.2f} s capturing [{ctx['card']}]")
    ctx["launches"] += run["launches"]
    ctx["scan"]["serve_launches"] = run["launches"]


def scan_train(ctx) -> None:
    """22b: phase 8's fit through a scanned model."""
    import torch

    from tony_tpu_torch.examples import lm_pretrain
    from tony_tpu_torch.models.convert import unstack_layers
    from tony_tpu_torch.ops import adamw, attention
    from tony_tpu_torch.train import fit

    cfg = qwen_config(dtype=torch.bfloat16, attention_backend="pallas",
                      remat=True, remat_policy="attn_saved",
                      scan_layers=True)
    model, trainer, loader = lm_pretrain.build(
        cfg, seed=SEED, micro=TRAIN_MICRO, accum=TRAIN_ACCUM,
        seq_len=TRAIN_SEQ, lr=TRAIN_LR, warmup=TRAIN_WARMUP, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    stamps = []

    def stamp(step, metrics):
        if not stamps:
            sync()
        stamps.append((step, time.perf_counter()))

    counters = (attention.flash_attention_fwd,
                attention.flash_attention_bwd_dq,
                attention.flash_attention_bwd_dkv, adamw.fused_adamw_update)
    for k in counters:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 30
    sync()
    result = fit(trainer, None, loader, num_steps=TRAIN_STEPS, log_every=1,
                 metric_sinks=[stamp])
    sync()
    t_end = time.perf_counter()
    launches = [k.launches for k in counters]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [h["loss"] for h in result.history if "loss" in h]
    eight = ctx["fit"]
    check(losses == eight["losses"],
          f"22b: losses {losses} against phase 8's {eight['losses']}")
    masters = unstack_layers(result.state.params)
    want = ctx["fit_masters"]
    check(sorted(masters) == sorted(want),
          "22b: the unstacked masters are not phase 8's leaves")
    differ = [n for n, t in masters.items()
              if not torch.equal(t.cpu(), want[n])]
    check(not differ, f"22b: {len(differ)} of {len(want)} final masters "
          f"differ from phase 8's: {differ[:4]}")
    per_fwd = cfg.n_layers * TRAIN_ACCUM * TRAIN_STEPS
    check(launches == [per_fwd] * 3 + [TRAIN_STEPS],
          f"22b: launches fwd/dq/dkv/adamw {launches}, expected "
          f"{[per_fwd] * 3 + [TRAIN_STEPS]}")
    calls = [trainer.graphs.calls["train_step", w]
             for w in ("captures", "replays", "eager")]
    check(calls == [1, TRAIN_STEPS - 1, 0],
          f"22b: train_step captures/replays/eager {calls}")
    check(peak <= 1.1 * eight["peak_gib"],
          f"22b: peak memory {peak:.2f} GiB, over 1.1 x phase 8's "
          f"{eight['peak_gib']:.2f}")
    step_ms = (t_end - stamps[0][1]) / (TRAIN_STEPS - 2) * 1e3
    tokens = TRAIN_MICRO * TRAIN_ACCUM * TRAIN_SEQ
    mfu = train_flops_per_token(cfg, n_params) * tokens \
        / (step_ms / 1e3) / PEAK_BF16
    print(f"phase 22b fit scanned Qwen2.5-1.5B (phase 8's recipe, weights "
          f"and batches): losses and all {len(want)} final masters "
          f"(unstacked) bit-equal to phase 8's; {step_ms:.1f} ms/step "
          f"(phase 8 {eight['step_ms']:.1f}), MFU {mfu:.4f} (phase 8 "
          f"{eight['mfu']:.4f}), peak memory {peak:.2f} GiB, "
          f"{peak - base:.2f} above the {base:.2f} resident at the start "
          f"(phase 8 {eight['peak_gib']:.2f}, "
          f"{eight['peak_gib'] - eight['base_gib']:.2f} above "
          f"{eight['base_gib']:.2f}); launches fwd/dq/dkv/adamw "
          f"{launches}, replays included; train_step captures/replays/"
          f"eager {calls} [{ctx['card']}]")
    ctx["scan"]["train_launches"] = launches
    del result, trainer, model, masters


def forward_peak(fn):
    """``fn()`` and the bytes it allocated above what was resident."""
    import torch

    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    sync()
    return out, torch.cuda.max_memory_allocated() - base


def scan_attention(ctx) -> None:
    """22c: the blocked attention loop at Qwen's heads, then a scanned
    model forward through it against the flash kernels."""
    import torch
    import torch.nn.functional as F

    import tony_tpu_torch.models.transformer as tmod
    from tony_tpu_torch.ops.attention import flash_attention
    from tony_tpu_torch.parallel import (blockwise_attention,
                                         reference_attention)

    n, h, kvh, d = SCAN_ATTN_LEN, 12, 2, 128
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 22)

    def draw(heads):
        return torch.randn(1, n, heads, d, generator=gen, device=DEVICE,
                           dtype=torch.bfloat16)

    q, k, v = draw(h), draw(kvh), draw(kvh)
    kr = k.repeat_interleave(h // kvh, dim=2)
    vr = v.repeat_interleave(h // kvh, dim=2)
    with torch.no_grad():
        got, peak_b = forward_peak(lambda: blockwise_attention(
            q, kr, vr, block_size=SCAN_ATTN_BLOCK))
        want, peak_r = forward_peak(lambda: reference_attention(
            q.float(), kr.float(), vr.float()))
    limit = 2.0 ** -8 * want.abs() + 1e-5 * vr.float().abs().max()
    err = (got.float() - want).abs()
    check(bool((err <= limit).all()),
          f"22c: blockwise_attention off the fp32 reference by up to "
          f"{err.max().item():.3g} (limit 2^-8 |want| + 1e-5 max|v|)")
    scores = h * n * n * 4
    check(peak_b < scores, f"22c: the blocked forward took {peak_b} bytes,"
          f" not below the [L, L] scores' {scores}")
    del want
    free_card()
    flush = ctx["flush"]
    with torch.no_grad():
        ms = {
            "blockwise": cuda_time_ms(lambda: blockwise_attention(
                q, kr, vr, block_size=SCAN_ATTN_BLOCK), 3, flush,
                ADAMW_HOLD),
            "reference": cuda_time_ms(lambda: reference_attention(
                q.float(), kr.float(), vr.float()), 1, flush),
            "flash_attention": cuda_time_ms(lambda: flash_attention(
                q, k, v, causal=True), 5, flush),
            "sdpa": cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), kr.transpose(1, 2), vr.transpose(1, 2),
                is_causal=True), 5, flush)}
    print(f"phase 22c blockwise_attention B=1 L={n} H={h} (K/V {kvh} heads "
          f"repeated) D={d} bf16, blocks of {SCAN_ATTN_BLOCK}: max abs err "
          f"{err.max().item():.3g} against the fp32 reference (within "
          f"2^-8 |want| + 1e-5 max|v|); peak memory above the inputs "
          f"{peak_b / 2 ** 30:.3f} GiB blocked, {peak_r / 2 ** 30:.3f} GiB "
          f"reference ([L, L] fp32 scores {scores / 2 ** 30:.3f} GiB); "
          + ", ".join(f"{name} {t:.2f} ms" for name, t in ms.items())
          + f" (SDPA a yardstick) [{ctx['card']}]")
    del q, k, v, kr, vr, got
    free_card()
    cfg = dataclasses.replace(qwen_config(dtype=torch.bfloat16,
                                          scan_layers=True),
                              max_seq_len=SCAN_FWD_LEN,
                              attention_backend="blockwise")
    blocked = scanned_qwen(cfg)
    flash = tmod.Transformer(dataclasses.replace(
        cfg, attention_backend="pallas"), device=DEVICE)
    flash.load_state_dict(blocked.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (1, SCAN_FWD_LEN),
                         generator=gen, device=DEVICE)
    plain = tmod.reference_attention

    def refuse(*a, **kw):
        raise AssertionError("the blockwise backend reached "
                             "reference_attention")

    last = {}
    tmod.reference_attention = refuse
    try:
        with torch.no_grad():
            for name, m in (("blockwise", blocked), ("pallas", flash)):
                hidden, peak = forward_peak(
                    lambda m=m: m(toks, return_hidden=True))
                last[name] = (m.logits(hidden[0, -1:])[0], peak)
                del hidden
    finally:
        tmod.reference_attention = plain
    # the smoke's rule for two bf16 paths: the same greedy token, or two
    # tokens within NEAR_TIE x the row's largest |logit| under each
    # path's own logits (the two attention forms round differently, and
    # 28 bf16 layers carry it: each bf16 prefill sits 3-4% of the
    # largest |logit| from fp32, tests/torch_bf16_partings.py)
    a, b = last["blockwise"][0], last["pallas"][0]
    ta, tb = int(a.argmax()), int(b.argmax())
    scale = max(a.abs().max().item(), b.abs().max().item())
    tie = max((a[ta] - a[tb]).item(), (b[tb] - b[ta]).item())
    diff = (a - b).abs().max().item()
    check(bool(torch.isfinite(a).all())
          and (ta == tb or tie <= NEAR_TIE * scale),
          f"22c: the scanned model's last greedy token, blockwise {ta} "
          f"against pallas {tb}, apart by {tie:.3g} > 2^-6 x {scale:.3g}")
    same = "the same" if ta == tb else \
        f"{ta} against {tb}, a near tie ({tie:.3g})"
    print(f"phase 22c scanned Qwen2.5-1.5B bf16 forward on 1 x "
          f"{SCAN_FWD_LEN} tokens, blockwise against pallas: the last "
          f"position's greedy token {same}; its logits apart by up to "
          f"{diff:.3g} ({diff / scale:.3g} of the largest |logit|); peak "
          f"memory above the weights {last['blockwise'][1] / 2 ** 30:.2f} "
          f"GiB blockwise, {last['pallas'][1] / 2 ** 30:.2f} GiB pallas "
          f"[{ctx['card']}]")
    del blocked, flash


# ------------------------------------------------------- mesh training

MESH_LAYERS = 4     # 23: two processes share the card and the clock
MESH_STEPS = 4
MESH_TIMEOUT = 420  # s a rank process or the gang's job may take


def mesh_config():
    """Phase 8's training configuration at ``MESH_LAYERS`` layers (the
    one ``examples/lm_pretrain.py`` builds from its ``--layers``)."""
    import torch

    from tony_tpu_torch.examples import lm_pretrain

    hf = {**QWEN25_15B, "num_hidden_layers": MESH_LAYERS}
    return lm_pretrain.train_config(hf, SERVE_MAX_LEN, dtype=torch.bfloat16)


def mesh_counters():
    from tony_tpu_torch.ops import adamw, attention

    return (attention.flash_attention_fwd, attention.flash_attention_bwd_dq,
            attention.flash_attention_bwd_dkv, adamw.fused_adamw_update)


def mesh_fit(trainer, loader) -> dict:
    """``fit`` for ``MESH_STEPS`` steps, timed from the end of step 2 on
    the card (a wrapper of ``trainer.step``: fit calls sinks on rank 0
    only); its losses, launches, peak memory and ms a step."""
    import torch

    from tony_tpu_torch.train import fit

    counters = mesh_counters()
    for c in counters:
        c.launches = 0
    marks = {"calls": 0}
    step = trainer.step

    def counted(state, batch):
        out = step(state, batch)
        marks["calls"] += 1
        if marks["calls"] == 2:
            sync()
            marks["t2"] = time.perf_counter()
        return out

    trainer.step = counted
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 30
    try:
        result = fit(trainer, None, loader, num_steps=MESH_STEPS,
                     log_every=1)
        sync()
        t_end = time.perf_counter()
    finally:
        trainer.step = step
    return {"result": result,
            "losses": [h["loss"] for h in result.history if "loss" in h],
            "launches": [c.launches for c in counters],
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "base_gib": base,
            "step_ms": (t_end - marks["t2"]) / (MESH_STEPS - 2) * 1e3}


def mesh_rank_main(out_dir: str) -> int:
    """One rank of 23a, in a process of its own: initialize from the env
    contract, train under FSDP on (data=1, fsdp=2), write this rank's
    readings (and, rank 0, the gathered masters) into ``out_dir``."""
    import torch

    sys.path.insert(0, ROOT)
    # what the reference (this script's main process) sets, and nothing
    # more
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tony_tpu_torch import distributed
    from tony_tpu_torch.examples import lm_pretrain
    from tony_tpu_torch.ops import adamw
    from tony_tpu_torch.parallel import FSDP, MeshSpec, make_mesh

    spec = distributed.initialize(timeout_s=MESH_TIMEOUT, device=DEVICE)
    mesh = make_mesh(MeshSpec(data=1, fsdp=2), device_type=DEVICE)
    rank = mesh.axis_index(FSDP)
    _, trainer, loader = lm_pretrain.build(
        mesh_config(), seed=SEED, micro=TRAIN_MICRO, accum=1,
        seq_len=TRAIN_SEQ, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
        device=DEVICE, mesh=mesh, fsdp=True)
    run = mesh_fit(trainer, loader)
    state = run.pop("result").state
    whole = trainer.gather_state(state).params
    if rank == 0:
        torch.save({n: t.cpu() for n, t in whole.items()},
                   os.path.join(out_dir, "masters.pt"))
    g = trainer.graphs
    doc = {**run, "rank": rank, "world": mesh.size(),
           "collectives": mesh_collective_check(mesh, rank),
           "backend": spec["backend"],
           "collective_s": trainer.collective_s,
           "elements": list(adamw.fused_adamw_update.elements),
           "sharded": len(trainer._shards), "leaves": len(whole),
           "calls": [g.calls["train_step", w]
                     for w in ("captures", "replays", "eager")]}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(doc, f)
    torch.distributed.barrier()
    return 0


def mesh_collective_check(mesh, rank: int) -> dict:
    """Each collective of ``parallel.collectives`` on CUDA tensors over the
    fsdp axis, against what it must give: ring_shift takes gloo's staged
    path (send/recv through pinned host buffers), the others gloo's own;
    gathers and scatters along dim 1. Returns op -> whether it held."""
    import torch

    from tony_tpu_torch.parallel import FSDP
    from tony_tpu_torch.parallel import collectives as col

    def mine(r):  # rank r's block, exact in fp32 and bf16
        return (torch.arange(24, device=DEVICE, dtype=torch.float32)
                .reshape(4, 6) + 100 * r)

    whole = torch.cat([mine(r) for r in range(2)], dim=1)
    x = mine(rank)
    got = {
        "all_reduce_sum": torch.equal(col.all_reduce_sum(x, FSDP, mesh),
                                      mine(0) + mine(1)),
        "all_gather": torch.equal(col.all_gather(
            x.bfloat16(), FSDP, mesh, axis=1), whole.bfloat16()),
        "reduce_scatter": torch.equal(col.reduce_scatter(
            whole, FSDP, mesh, axis=1), 2 * mine(rank)),
        "ring_shift": torch.equal(col.ring_shift(x, FSDP, mesh),
                                  mine(1 - rank))}
    sync()
    return got


def wait_ranks(procs: list, logs: list, tag: str, limit: float) -> None:
    """Wait for every rank process within ``limit`` seconds, then kill
    the process group of any still running; on any failure print each
    rank's exit code and the tail of its output, and fail."""
    deadline = time.monotonic() + limit
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=max(deadline - time.monotonic(), 1)))
        except subprocess.TimeoutExpired:
            rcs.append(f"killed after {limit:.0f} s")
    for p in procs:
        if p.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    if any(rc != 0 for rc in rcs):
        for r, (rc, log) in enumerate(zip(rcs, logs)):
            with open(log, errors="replace") as f:
                tail = f.read()[-3000:]
            print(f"{tag} rank {r}: exit {rc}; its output ends:\n{tail}",
                  file=sys.stderr)
        raise PhaseError(f"{tag}: rank exit codes {rcs}")


def phase_mesh_train(ctx) -> None:
    """23: the reference in this process, then FSDP over two rank
    processes, then a two-worker gang through the control plane."""
    import torch

    from tony_tpu_torch.examples import lm_pretrain

    cfg = mesh_config()
    model, trainer, loader = lm_pretrain.build(
        cfg, seed=SEED, micro=TRAIN_MICRO, accum=2, seq_len=TRAIN_SEQ,
        lr=TRAIN_LR, warmup=TRAIN_WARMUP, device=DEVICE)
    ref = mesh_fit(trainer, loader)
    ref_calls = [trainer.graphs.calls["train_step", w]
                 for w in ("captures", "replays", "eager")]
    check(ref_calls == [1, MESH_STEPS - 1, 0],
          f"23r: train_step captures/replays/eager {ref_calls}")
    per = MESH_LAYERS * 2 * MESH_STEPS
    check(ref["launches"] == [per] * 3 + [MESH_STEPS],
          f"23r: launches fwd/dq/dkv/adamw {ref['launches']}")
    losses = ref["losses"]
    masters = {n: t.to("cpu", copy=True)
               for n, t in ref.pop("result").state.params.items()}
    print(f"phase 23r reference: Qwen2.5-1.5B width, {MESH_LAYERS} layers, "
          f"one process, fit at accum_steps=2 on {TRAIN_MICRO} x 2 x "
          f"{TRAIN_SEQ} tokens a step, captured: losses "
          f"{[round(x, 4) for x in losses]}; {ref['step_ms']:.1f} ms/step, "
          f"peak memory {ref['peak_gib']:.2f} GiB; launches fwd/dq/dkv/"
          f"adamw {ref['launches']} [{ctx['card']}]")
    del model, trainer, loader
    free_card()
    free, total = torch.cuda.mem_get_info()
    print(f"phase 23: the card's free memory {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB before the ranks (this script's cache "
          f"released) [{ctx['card']}]")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_mesh_",
                            dir=os.path.join(ROOT, "build"))
    try:
        ranks = mesh_fsdp(ctx, root, losses, masters)
        gang = mesh_gang(ctx, os.path.join(root, "gang"), losses)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ctx["mesh"] = {"ref": ref["launches"],
                   "ranks": [r["launches"] for r in ranks],
                   "gang": [r["launches"] for r in gang]}


def mesh_fsdp(ctx, root: str, losses: list, masters: dict) -> list:
    """23a: two rank processes, FSDP, against 23r bit for bit."""
    import socket

    import torch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    t0 = time.perf_counter()
    for r in range(2):
        log = os.path.join(root, f"rank{r}.log")
        logs.append(log)
        env = {**os.environ, "PYTHONPATH": ROOT,
               "TONY_JAX_COORDINATOR": f"127.0.0.1:{port}",
               "TONY_PROCESS_ID": str(r), "TONY_NUM_PROCESSES": "2"}
        with open(log, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                 "--mesh-rank", root], cwd=ROOT, env=env, stdout=out,
                stderr=subprocess.STDOUT, start_new_session=True))
    wait_ranks(procs, logs, "23a", MESH_TIMEOUT)
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    per = MESH_LAYERS * MESH_STEPS
    for r in ranks:
        tag = f"23a rank {r['rank']}"
        check(r["backend"] == "gloo" and r["world"] == 2,
              f"{tag}: backend {r['backend']}, world {r['world']}")
        check(r["losses"] == losses, f"{tag}: losses {r['losses']} "
              f"against 23r's {losses} (held bit-equal)")
        check(r["launches"] == [per] * 3 + [MESH_STEPS],
              f"{tag}: launches fwd/dq/dkv/adamw {r['launches']}, "
              f"expected {[per] * 3 + [MESH_STEPS]}")
        check(r["elements"][0] < r["elements"][1] and r["sharded"] > 0,
              f"{tag}: fused AdamW's local/whole elements {r['elements']}"
              f", {r['sharded']} sharded leaves")
        check(r["calls"] == [0, 0, MESH_STEPS],
              f"{tag}: train_step captures/replays/eager {r['calls']}")
        check(all(r["collectives"].values()),
              f"{tag}: collectives on CUDA tensors {r['collectives']}")
    got = torch.load(os.path.join(root, "masters.pt"), weights_only=True)
    check(sorted(got) == sorted(masters), "23a: the gathered masters are "
          "not 23r's leaves")
    differ = [n for n, t in got.items() if not torch.equal(t, masters[n])]
    check(not differ, f"23a: {len(differ)} of {len(masters)} gathered "
          f"masters differ from 23r's: {differ[:4]}")
    print(f"phase 23a FSDP over two rank processes on one card "
          f"(gloo, MeshSpec(data=1, fsdp=2), accum_steps=1, {TRAIN_MICRO} "
          f"rows a rank): losses and all {len(masters)} gathered fp32 "
          f"masters bit-equal to 23r's; on CUDA tensors over gloo "
          f"{', '.join(ranks[0]['collectives'])} equal to their sums and "
          f"gathers (ring_shift staged through pinned host memory); wall "
          f"{wall:.1f} s with the processes' start [{ctx['card']}]")
    for r in ranks:
        local, whole = r["elements"]
        print(f"phase 23a rank {r['rank']}: {r['step_ms']:.1f} ms/step "
              f"(eager), {r['collective_s']:.2f} s in collectives over "
              f"{MESH_STEPS} steps and the gathers, peak memory "
              f"{r['peak_gib']:.2f} GiB ({r['peak_gib'] - r['base_gib']:.2f}"
              f" above its resident start); fused AdamW once a step over "
              f"{local} local of {whole} elements ({r['sharded']} of "
              f"{r['leaves']} leaves sharded); launches fwd/dq/dkv/adamw "
              f"{r['launches']} [{ctx['card']}]")
    return ranks


def mesh_gang(ctx, root: str, losses: list) -> list:
    """23b: a two-worker gang through the control plane, against 23r."""
    os.makedirs(root)
    task = ["--layers", str(MESH_LAYERS), "--steps", str(MESH_STEPS),
            "--micro", str(TRAIN_MICRO), "--accum", "1", "--seq-len",
            str(TRAIN_SEQ), "--max-seq-len", str(SERVE_MAX_LEN), "--lr",
            str(TRAIN_LR), "--warmup", str(TRAIN_WARMUP), "--seed",
            str(SEED), "--result", os.path.join(root, "r{rank}.json")]
    job = run_job(ctx, "23b", root, task, workers=2, chips=None,
                  timeout=MESH_TIMEOUT)
    if job["rc"] != 0:
        print(f"23b: cli.local exited {job['rc']}; its output ends:\n"
              f"{job['out'][-3000:]}", file=sys.stderr)
        for log in sorted(glob.glob(os.path.join(
                job["job_dir"], "logs", "worker-*"))):
            with open(log, errors="replace") as f:
                print(f"23b {os.path.basename(log)} ends:\n"
                      f"{f.read()[-2000:]}", file=sys.stderr)
        raise PhaseError(f"23b: cli.local exited {job['rc']}")
    types = job_events(job, "23b")
    check(job["history"][0]["status"] == "SUCCEEDED",
          f"23b: history {job['history'][0]['status']}, events {types}")
    res = []
    for r in range(2):
        with open(os.path.join(root, f"r{r}.json")) as f:
            res.append(json.load(f))
    for r, doc in enumerate(res):
        check(doc["rank"] == r and doc["world"] == 2
              and doc["backend"] == "gloo",
              f"23b worker {r}: rank {doc['rank']}, world {doc['world']}, "
              f"backend {doc['backend']}")
        check(doc["losses"] == losses, f"23b worker {r}: losses "
              f"{doc['losses']} against 23r's {losses} (held bit-equal)")
    print(f"phase 23b a two-worker gang: cli.local -> coordinator -> two "
          f"agents -> lm_pretrain.py on data_parallel_mesh(), "
          f"tony.worker.instances=2 and no chips (both on the card), "
          f"--micro {TRAIN_MICRO} --accum 1: SUCCEEDED, both workers on "
          f"gloo in a world of 2, losses bit-equal to 23r's; submit to "
          f"SUCCEEDED {job['wall']:.2f} s [{ctx['card']}]")
    for doc in res:
        ms = "not measured" if doc["step_ms"] is None \
            else f"{doc['step_ms']:.1f} ms/step"
        peak = "not measured" if doc["peak_gib"] is None \
            else f"{doc['peak_gib']:.2f} GiB"
        print(f"phase 23b worker {doc['rank']}: {ms}, "
              f"{doc['collective_s']:.2f} s in collectives, peak memory "
              f"{peak}; launches "
              f"{json.dumps(doc['launches'])} [{ctx['card']}]")
    return [{"launches": [d["launches"][k] for k in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv", "fused_adamw")]} for d in res]


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
                        ("fabric", phase_fabric), ("job", phase_job),
                        ("finetune", phase_finetune), ("moe", phase_moe),
                        ("zoo", phase_zoo), ("scan", phase_scan),
                        ("mesh-train", phase_mesh_train)):
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
            + train_kernel_lines(ctx) + int8_kernel_lines(ctx) \
            + finetune_kernel_lines(ctx) + moe_kernel_lines(ctx) \
            + zoo_kernel_lines(ctx)
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
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(sys.argv[2]))
    sys.exit(main())
