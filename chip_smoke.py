#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (`src/repro_torch/`): proves on one NVIDIA
GPU that the port builds, that each hand-written kernel agrees with its plain
PyTorch version, and that the serving path and the training path run through
those kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):
  1. device  — a CUDA device must be present; prints the card's name and
               power limit as nvidia-smi reports them.
  2. build   — compiles the CUDA sources (kernels/csrc/*.cu) with nvcc.
  3. kernels — every kernel against its plain version at the shapes the
               llama-200m serving path gives it, and the quantizer and the
               GEMM at every shape of one full-width training step (T =
               2048 bf16 activations; the forward, dX and dW GEMMs), with
               the port's bars; the quantizer also on both of its plan
               regimes at their boundaries and one past, at deepseek-v3's
               decode shapes and on edge inputs (zeros, one huge element
               in the last chunk, denormals), and timed as whole calls
               (every kernel a call launches) over one step of llama-200m
               decode (70 calls), deepseek-v3 decode (197) and training
               (140); the GEMM also at M = 1, 8, 16, 17 (both
               kernels and their boundary) and at deepseek-v3's decode
               shapes (M = 8 and 4), its bf16 output bitwise the f32
               output's cast, and timed over one deepseek-v3 decode step's
               calls and one training step's 210 GEMMs as well; times
               one decode step's worth of calls of each (CUDA events): the
               kernel, the plain version, a PyTorch yardstick call, and the
               least time the card could take (bytes or operations).
               The two MS-EDEN requant phases at every operand shape of one
               full-width training step (T = 2048 tokens), an M that is no
               multiple of 128 and an all-zero tensor, bitwise; phase 2
               both with uniforms hashed in the kernel from a key pair and
               with a uniforms tensor, one operand and both operands of
               each backward GEMM a launch; phase 1 also on every operand
               as the backward hands it (E^T, W^T, X^T as transposed views
               read in place); the quartet2 backward GEMM against its plain
               composition; the 280 phase-1 calls and the 140 two-operand
               phase-2 launches of one training step timed on those views
               (phase 1 also on contiguous copies; phase 2 also as 280
               one-operand launches on uniforms tensors, and the 280
               uniform draws it no longer needs timed apart). The packed
               GQA decode (#6) at llama-200m's decode and chunk shapes and
               the MLA decode over bf16 (#7, on the tensor cores) and NVFP4
               (#8) latent pools at deepseek-v3's (H 128, lora 512, rope 64;
               Sq 1 and 16, ragged lengths, an inactive row, 4 rows x 4,096
               tokens; each kernel's two calls bitwise equal), each timed
               over one decode step's calls at phase 6's lengths and at
               4,096 tokens (#7's bound at the bf16 tensor-core peak). The split-KV GQA decode (#5, #6) also on cases that
               stress its splits (yi-9b at Sq 1 and 16 over the NVFP4 pool;
               over both pools a 1,024-token row, lengths ending on a split
               edge and one past it, windows that leave whole splits dead),
               two calls bitwise equal. Every kernel's time is also read
               from the profiler (its own device time), and so is the
               yardstick call's. Then the whole paged step (llama-200m;
               deepseek-v3 with both pools) and a quartet2 train step at
               reduced size, card against CPU.
  4. serving — full-width llama-200m (seeded random weights), quartet2,
               quantize-once weights, paged bf16 pool, 4 slots: 8 requests
               with ragged prompts of 16-100 tokens, 32 new tokens each,
               through ServeEngine; every kernel must have launched.
  4b. the same with kv_quant=True (the NVFP4 pool): paged_gqa_q launched,
               paged_gqa not, the pool's token leaves uint8 at 0.28125x the
               bf16 bytes.
  6. deepseek-v3 at its published widths, depth cut to 2 layers (two whole
               MLA + MoE periods; 61 layers of 6.54 GB packed do not fit
               one card), quartet2, weights packed as drawn (init_packed),
               4 slots, 4 requests of 16-64 prompt tokens and 16 new tokens
               each, once with the bf16 latent pool (paged_mla) and once
               with the NVFP4 pool (paged_mla_q).
  5. training — full-width llama-200m, quartet2, AdamW, warmup-cosine at
               base lr 2e-3, batch 8 x seq 256 on the synthetic corpus, 6
               steps through `repro_torch.launch.train`: losses and weights
               finite, the last loss below the first, each of the four
               kernels of the path launched the expected number of times
               (phase 2 once per backward GEMM), and no SR uniform tensor
               drawn (phase 2 hashes them); then one step under the
               profiler, with all its launches and its PyTorch copy, abs,
               reduction and int64 launches counted (so in the decode
               profiles of phases 4, 4b and 6).
  7. pre-training as users run it, through `Trainer` (checkpoints in a
               temporary directory, removed at the end; the free disk is
               checked against two checkpoints' bytes first, and too little
               fails the run):
     7a. resume — full-width llama-200m, quartet2, AdamW, batch 8 x seq 256:
               run A takes 8 steps with an async checkpoint every 4 (the
               reference's rule puts it after the step of index 4, so it
               holds 5 steps; keep 1); a fresh Trainer over freshly built
               state resumes from it and runs to 8. Check 1: the restored
               leaves are bitwise a host snapshot A took of that state.
               Check 2: the resumed run's first loss is bitwise A's at that
               step. Check 3: an uninterrupted repeat B of A; if A and B
               agree bitwise, the resumed run must equal A bitwise in its
               later losses and final weights, otherwise it is held to the
               A-B spread, and the ops PyTorch reports as nondeterministic in
               a step (use_deterministic_algorithms, warn_only) are named.
               Prints the host ms save(blocking=False) blocks, the write's
               seconds, the bytes on disk and the step times around it.
     7b. the nanochat recipe — llama-200m widths with QK-norm and ReLU^2,
               quartet2, Muon, WSD, 6 steps, QuantProbe(every_n=2): finite
               losses and weights, the last loss below the first, kernels
               #1-#4 launched exactly as counted (the probe's included); the
               probe's MS-EDEN and SR relative MSE beside the paper's Table 1
               (9.4e-3, 23.5e-3), SR's at least 2x MS-EDEN's at each probe;
               one site's probe on the card within PROBE_CPU_RTOL of the same
               probe on the CPU; one step profiled, with Newton-Schulz's
               share of its device time.
  8. serving with shared prompts (the prefix cache, its host tier and the
               latency-aware scheduler), on the first SHARED_LLAMA_LAYERS (5)
               of phase 4's 10 llama layers (views: nothing drawn twice; a
               depth cut for the time limit) and phase 6's packed
               deepseek-v3 weights:
     8a. llama-200m, quartet2, both pools, 4 slots, max_len 512, block and
               chunk 16: 8 requests of a 384-token system prompt plus 32
               tokens of their own, 32 new tokens, cold (cache off) and hot
               (primed with the system prompt): exact prefill and skip
               counts, every block free or cache-owned, the pool's attention
               kernel launched; TTFT, decode tok/s, peak memory.
     8b. the reference's Zipf tenant mix (6 tenants, exponent 1.1, 12
               requests of a 128-token tenant prefix + 16 tokens, 4 new, in
               a 24-block pool (2 slots, max_len 192), cache drop against host
               spill, and spill with the host tier bounded at half the
               unbounded run's snapshots: cache and engine counts equal a
               reduced CPU run's, the bounded run reuses pinned buffers;
               hit rate, p50/p99 latency, host ms a spill (first, later,
               into a fresh or a reused buffer), a swap-in's dispatch and
               device ms (CUDA events), host bytes.
     8c. scheme bf16 at full width, both pools: cold, device-hot and
               spill-hot streams of a block-aligned match bitwise equal, a
               host round trip byte-identical (uint8 for NVFP4); a COW match
               (ending 8 tokens into a block): the K/V of the matched 392
               positions byte-identical to the cold run's, the spill-hot
               COW stream and its K/V bitwise the device-hot one's (the
               same step shapes); against the cold stream (the rest of the
               prompt in other step shapes) bitwise or, over the bf16
               pool, equal up to the first token whose cold top-2 margin is
               within BF16_TIE_ULPS bf16 ulps with at least half compared;
               over the NVFP4 pool reported, not held (an ulp of K/V moves
               codes); the first differing token printed.
     8d. LatencyPolicy(aging_ticks=8) against FIFO: 9 background requests,
               then 3 critical ones (priority 2, deadline 1 s); by a
               tick-counting clock the admission order and prefill picks
               equal a reduced CPU run's; by the real clock, latency by class
               and the deadlines met.
     8e. deepseek-v3 (2 layers), both latent pools: 3 requests over a
               48-token prefix, the first alone: 2 x 48 tokens skipped, the
               MLA kernel launched over adopted blocks, finite logits, the
               pool conserved.
  9. self-speculative decoding, cancel and the token hook (the first
               SHARED_LLAMA_LAYERS (5) of phase 4's 10 llama layers, as
               phases 8 and 10 cut them, and phase 6's weights, bf16 pools):
               the kernels at a verify chunk's shapes against their plain
               versions and timed (#2 at M = 16 and 20, #5 and #7 at Sq 4
               from mid-sequence positions);
     9a. llama-200m quartet2, phase 4's prompts with 16 new tokens, spec_k
               3 over 2 draft layers: acceptance, tokens a slot a round,
               decode tok/s
               against the non-speculative engine on the same traffic and
               layers, a second run bitwise, the streams' agreement with
               it (reported); over SPEC_ROUNDS (4) full-batch rounds a round's
               host ms, device ms of the draft, catch-up and verify (the
               kernels inside each range's card-side span), launches by
               kernel and regime, host syncs by source (sync debug mode).
     9b. scheme bf16: the verify chunk's logits within VERIFY_STEP_ULPS of
               single-token steps over the same tokens (held); phase 4's
               streams spec against non-spec by the tie rule (reported).
     9c. spec_k 4: the verify's device ms with #2 at M = 20 (wgmma).
     9d. deepseek-v3 (2 layers), spec_k 3 over 1 draft layer: as 9a.
     9e. 8a's shared-prompt traffic hot: the draft's catch-up over the
               skipped tokens (3,072 in 192 forwards) and every count equal
               to a reduced CPU run's.
     9f. cancel of an in-flight and a queued request, both pools freed,
               the resubmission a cache hit, the hook's tokens each result's.
 10. serving over HTTP (the first 5 of phase 4's llama layers, as phase
               8 cuts them, and phase 4's requests, 4 slots, 32 new tokens
               each) through `serve/frontend.py`: the engine ticks
               on the bridge's thread, an asyncio loop serves HTTP on
               127.0.0.1 (an ephemeral port), obs on. #1, #2 (M 4 gemv, M 64
               wgmma), #5 and #6 launched on the bridge's thread: bitwise the
               main thread's launches, within their bars of the plain
               versions. Every await and join is bounded (HTTP_WAIT_S); an
               HTTP 500, an engine-thread fault or a thread that does not
               stop fails the phase.
     10a. quartet2, bf16 pool, prefix cache: 8 concurrent SSE clients; every
               stream whole, every block free after the cache is emptied;
               decode tok/s and TTFT p50/p99 (client-seen and the trace's)
               against engine.run() of the same traffic (the streams'
               agreement reported, not held); /metrics bytes and ms; run()
               with obs on bitwise obs off; on direct engine.step() calls in
               the main thread, host and device ms a decode step and host
               syncs a step with obs on and off (the syncs held equal).
     10b. scheme bf16 over the bf16 and the NVFP4 pool, phase 4's first 4
               requests: the SSE streams bitwise run()'s, obs on bitwise off.
     10c. bf16 lifecycles: a client reset mid-stream (cancelled
               "disconnected", blocks reclaimed, the follow-up a prefix hit;
               its agreement with run() reported); 429 with Retry-After at max_queue
               1; a spent tenant budget 429; drain under load (in-flight
               finish bitwise, new ones 503, drained set); the
               reason-labelled rejection counters in /metrics; on a fake
               clock, visibility requeue and a resume bitwise the
               uninterrupted stream.
 11. fixed-batch generation over dense caches (`serve.decode.greedy_generate`:
               one prefill through `lm.forward(mode="prefill")`, then batched
               single-token steps, every raw weight re-quantized each step),
               on phase 4's raw llama weights and phase 6's packed
               deepseek-v3 weights (nothing drawn twice):
     11a. llama-200m quartet2, phase 4's first 4 prompts right-padded, 32
               new tokens: finite logits, #1 and #2 launched exactly 140 and
               70 times a forward (32 forwards), bf16_matmul once a forward
               (the bf16 head) and no other kernel, a second
               run bitwise; host and device ms a decode step, tok/s; #1 and
               #2 at the prefill's M (4 x the longest prompt) against their
               plain versions and one prefill's calls of each timed; the
               streams' agreement with phase 4's paged engine (reported).
     11b. scheme bf16: prefill + 3 decode steps within 5% of max|logit| of
               the train-mode forward; ragged rows against each row
               generated alone, the engine over dense caches (4 slots, chunk
               16) against the paged engine (#5 against plain einsums) and
               against greedy_generate, each by the tie rule: every token
               before its row's first BF16_TIE_ULPS near-tie equal, at least
               one compared a row on average (random full-width weights put
               a near-tie in the first few tokens of most rows, so the
               tests' half-compared floor is reported, not held).
     11c. deepseek-v3 (2 layers) quartet2, phase 6's packed weights and 4
               prompts, 16 new: prefill through the expanded-form MLA, decode
               over the dense latent caches; finite logits, no attention
               kernel launched; a dense engine's streams finite; agreement
               with phase 6's paged engine reported (expanded-form prefill
               quantizes wkv_b, absorbed decode does not).
     11d. one 16,384-token prompt, llama-200m quartet2, 4 new tokens: the
               prefill takes chunked_sdpa in all 10 layers; layer 0's within
               2e-3 of plain sdpa on the same (f32) q, k, v; #1 and #2 at M =
               16,384 against their plain versions; chunked_sdpa, plain sdpa
               and F.scaled_dot_product_attention (a yardstick) timed; peak
               memory.
 12. the rest of the transformer registry, MoE and MLA training (each model
               drawn from its own seed; nothing of phases 4-11 is reused):
     12a. granite-8b, chatglm3-6b, nemotron-4-15b, llava-next-mistral-7b (text
               prompts, as the engine serves it) and deepseek-moe-16b at their
               published widths, each cut to 4 layers for the time limit
               (REGISTRY_LAYERS), quartet2, weights packed as drawn
               (`init_packed`, PACK_CHUNK matrices of f32 at a time),
               bf16 paged pool, 4 slots, 4 requests of 16-64 prompt tokens
               and 8 new tokens each; chatglm3-6b again over the NVFP4 pool.
               Each run: tokens in the vocabulary, every block free, #1, #2
               and #5 (#6 over the NVFP4 pool) launched and no other
               attention kernel; decode tok/s, host and device ms of a
               decode step and the busy share (1 profiled step), host
               syncs of one decode step by source,
               peak memory, resident and packed weight bytes.
     12b. #5 and #6 at the registry's group sizes, H/KV 4 (granite, llava),
               6 (nemotron), 16 (chatglm3) and 1 (deepseek-moe), hd 128, Sq 1
               and 16, both pools, against their plain versions within the
               attention bar, two calls bitwise equal; one decode step's
               calls of each config timed with the bound and SDPA.
     12c. llava: stub embeds of 2 x 64 through `make_prefill_step` into dense
               caches, then 4 decode steps from tokens through
               `make_serve_step`: finite, a second run bitwise, #1 / #2
               launches reported.
     12d. deepseek-moe-16b at its published widths, depth cut to 2 layers
               (about 9 GB of f32 state a layer: 28 do not fit one card),
               quartet2, AdamW, batch 4 x 256, 2 steps through
               `repro_torch.launch.train`'s code path: losses and weights
               finite, the loss equal to its CE and aux read on their own
               (ce + 0.01 x aux) with aux > 0, #1-#4 launched, no SR uniform
               tensor drawn; ms and device ms a step, busy share, peak
               memory, host syncs a step by source (the expert loop's among
               them). Then the same recipe under bf16 (its losses beside
               quartet2's), and a reduced deepseek-moe-16b quartet2 train
               step x3, the card against the CPU within 1e-3 relative (as
               phase 3's reduced llama-200m step).
     12e. one `mla_apply` forward + backward at deepseek-v3's published
               widths (H 128, q_lora 1536, kv_lora 512 + rope 64) over 2 x
               64 tokens, quartet2, with tensor draws injected as the
               reference's tests inject theirs, the card against the CPU:
               the output within MLA_TRAIN_REL_RMS, every gradient by the
               quartet2 noise rule (below Q2_NOISE_FRACTION of the CPU's
               quartet2-bf16 distance, both on the card), beside the card
               against itself with x moved one bf16 ulp; wkv_a's 576-wide dX contraction padded
               to 640, that GEMM on the card within 1e-3 max|C| of its plain
               composition on the same operands; #1-#4 launched.
               deepseek-v3 does not train on one card at its widths (one
               MoE layer's f32 state is about 180 GB).
     12f. #1, #2 and #3/#4 against their plain versions at every shape
               12a, 12c and 12d gave them (`KernelShapes`): #1 by
               `check_quant`, #2 by `check_matmul` (both regimes), each
               backward GEMM's operands as laid out, phase 1 and phase 2
               bitwise and the GEMM within 1e-3 max|C| of its plain
               composition; the errors go into the kernels line.
 13. the recurrent families (rwkv6-7b: time-mix and channel-mix over the wkv
               / tm_prev / cm_prev state kinds; recurrentgemma-9b: RG-LRU
               blocks over the lru state kind and MQA lattn layers at hd 256
               under a 2,048 window), each drawn from its own seed:
     13a. both at their published widths, rwkv6-7b cut to 8 of 32 layers and
               recurrentgemma-9b to 6 of 38 (two whole patterns;
               RECURRENT_LAYERS), quartet2, weights drawn raw and packed
               once, 4 slots, 4 requests of 16-64 prompt tokens and 8 new
               tokens; recurrentgemma over the bf16 and the NVFP4 pool (#5,
               #6 at hd 256 with the window), rwkv6 with no attention kernel;
               each as 12a reports it. Then one recurrentgemma request of
               2,304 prompt tokens + 32 new in a one-slot engine: blocks
               held against the blocks its length needs (the window's
               reclaim mid-sequence), every block free after it.
     13b. scheme bf16 over the raw weights: rwkv6 at spec_k 3 over 2 draft
               layers, its stream bitwise the non-speculative engine's (the
               verify chunk of 4 stays on the per-token WKV path, and its
               f32 LoRAs run in calls of one shape);
               recurrentgemma at spec_k 3 over 3 draft layers, equal before
               the first 2-ulp near-tie; every state restore after a
               rejecting round bitwise its snapshot; acceptance, tokens a
               slot a round.
     13c. `greedy_generate` on recurrentgemma under bf16 with ring caches (2
               prompts of 2,080 tokens, caches of the 2,048 window: the
               prefill rolls, decode wraps), against the paged engine by the
               tie rule.
     13d. #5 and #6 at H 16 / KV 1, hd 256, block 16, Sq 1 and 16, windows
               2,048 and 64 over 4 x 4,096-token tables against their plain
               versions (the attention bar, unit-scale K/V), two calls
               bitwise; at 3x K/V #5 within the bar of float64 attention
               (the plain version's own distance beside it); one decode
               step's 12 lattn calls timed under each window (5g/6f, 5h/6g)
               with the bound (the keys inside the windows) and SDPA.
     13e. training at published widths, rwkv6-7b at 2 layers and
               recurrentgemma-9b at 3 (one pattern), quartet2, AdamW, batch 4
               x 256, 2 steps through `launch.train`'s code path: finite,
               #1-#4 launched and counted a step, no SR uniform tensor; ms
               and device ms a step, busy share, peak memory; a reduced
               quartet2 step x3 of each, card against CPU.
     13f. #1-#4 against their plain versions at every shape 13a and 13e gave
               them (12f's checks: the new K of 12,288 and 14,336).
 14. whisper's encoder-decoder path (`lm.forward`'s encode, prefill and
               decode modes; seeded raw weights, every weight quantized
               where it is used, as the reference's whisper path has no
               engine):
     14a. whisper-tiny at its published widths and depth (4 + 4 layers, d
               384, vocab 51,865), 4 rows of 1,500 stub frames (30 s of
               audio) and a 4-token decoder prompt: encode + prefill into
               `lm.init_encdec_cache` (448 positions), then 60 greedy decode
               steps (the cross K/V projected anew each step, as the
               reference does), under quartet2 and bf16. Held: #1/#2 launches
               exact (encode + prefill 128 + 64, a decode step 80 + 40),
               tokens in the vocabulary, finite logits, the bf16 decode
               logits within 5% of max|logit| of one train-mode forward over
               the same tokens; decoder tok/s, host and device ms a decode
               step and the busy share (4 profiled steps); a reduced encode +
               prefill + 3 decode steps and a reduced quartet2 train step x3,
               card against CPU.
     14b. training at published widths through `make_train_step`
               (quartet2, AdamW), batch 8 x (1,500 frames, 448 tokens), 3
               steps: finite, #1-#4 a step exact (128 / 192 / 256 / 128); ms
               and device ms a step, busy share, peak memory.
     14f. #1-#4 against their plain versions at every shape 14a and 14b gave
               them (12f's checks), and #2 over one decode step's 40 GEMMs
               timed (row 2g).
 15. disaggregated prefill/decode (`serve.frontend.make_disagg_pair`: a
               prefill worker hands each finished prompt's blocks to a decode
               worker through pinned host buffers; one set of packed weights)
               on the first SHARED_LLAMA_LAYERS (5) of phase 4's llama
               layers, 4 slots a worker:
     15a. 8 requests of 16-64 tokens, 32 new, through the single engine and
               the pair, under bf16 over the bf16 and the NVFP4 pool and under
               quartet2: the bf16 streams bitwise the single engine's (or by
               the tie rule, printed), both pools free and every payload
               buffer back, a handoff each, no prefill forward on the decode
               worker; handoff bytes, host ms an export and an import, TTFT
               and inter-token gap p50/p99 against the single engine,
               resident bytes.
     15b. cancel one request in transit and one queued on the decode
               worker, then drain: both pools conserved.
     15c. SSE over the pair through `CompletionFrontend`, bitwise the
               pair's run() under bf16.
 16. the distribution layer (`repro_torch.dist`): DP_RANKS (2) ranks
               spawned by `dist.spawn`, sharing the one card over a gloo
               group (NCCL refuses two ranks on one device); each loads the
               built kernel library and runs, in one group:
     16a. data-parallel Quartet II training of full-width llama-200m
               through the entry point (`launch.train.run` with `--dp 2
               --backend gloo` on each rank, as `--dp` spawns it), phase
               5's recipe (quartet2, AdamW, warmup-cosine at lr 2e-3,
               a global batch of 8 x 256, 4 rows a rank: `batch_at(step,
               rank, 2)`), DP_STEPS (3) steps: #1-#4 launched 140 / 210 /
               280 / 140 a rank a step, exactly; the ranks' params bitwise
               equal after every step (`dist.checksum`); held against this
               process's own run of 2 microbatches over the two shards laid
               end to end: losses, grad norms and every param bitwise
               (DP_HEAD_REL_RMS only if cuBLAS's f32 head differed between
               processes, said so). Seconds a step, the all-reduce's host
               ms, one more step profiled a rank (#1-#4 against every other
               kernel), peak memory a rank.
     16b. the same with `--compress` for DP_COMPRESSED_STEPS (2) steps
               (`compressed_grad_mean`: NVFP4 SR round trip, f32 sum, in
               place of the exact mean): finite
               losses, rank-identical params; on step 0's grads every leaf's
               compressed mean against the exact mean: the median leaf's
               relative error above COMPRESS_MEDIAN_FLOOR (0.05: the round
               trip ran) and under COMPRESS_MEDIAN_BAR (0.2), the largest
               reported.
     16c. GPipe (`dist.pipeline.gpipe`): two stages of tanh(qlinear(x, w))
               at d 2,048 under quartet2, 4 microbatches of 256 rows, #1
               and #2 launched on every tick: equal to the stages applied
               in order (bitwise, or within 1e-5), with NVFP4 boundaries
               within 0.30 relative; the bubble fraction.
     16d. NCCL at world size 1 in this process: a DP step equal to the
               plain step bitwise (2 steps), `compressed_psum_mean` equal to
               `_sr_roundtrip` bitwise for the same uniforms.
     16f. #1-#4 against their plain versions at every shape 16a and 16c
               gave them (12f's checks).
  17. mesh-sharded serving: llama-200m's first 4 layers (phase 4's
               weights) through `ServeEngine(EngineConfig(mesh=
               make_serve_mesh(2, 1, devices=["cuda:0"] * 2)))`, 4 slots, 2
               a shard, both shards on the one card; 4 requests of 17-49
               tokens, 12 new.
     17a. bf16: every step of each shard bitwise the unsharded step over
               the shard's slice (the bf16 pool's greedy run); the teacher-forced sharded step at 0 bf16
               ulps of the whole-batch unsharded step over the bf16 pool
               (held; the NVFP4 pool's distance reported: the serving bf16
               GEMMs run bf16_matmul, whose sums do not depend on the row
               count); the served streams over both pools, greedy, and
               sampled (temperature 0.8, top-k 8) over the bf16 pool:
               bitwise the unsharded engine's, held.
     17b. quartet2 with prequant: two sharded runs bitwise; every step of
               each shard bitwise the unsharded step over that shard's
               slice (a copy of its tree, its rows, its tables).
     17c. 2 slots (one a shard), prefix cache with its host tier and
               replicate_hits 1: a prompt cached and hit on shard 0 is
               copied into shard 1 at tick boundaries; the same prompt
               placed on shard 1 admits hot with no swap-in, bitwise the
               cold stream.
     17d. bf16 spec_k 3 over 2 draft layers, sharded: against the sharded
               non-spec streams, bitwise or by 9b's tie rule (reported).
     17e. #5-#8 against their plain versions on shard-local tables and
               shard leaves of blocks_per_shard + 1 blocks (a random scratch
               block, an all-sentinel row).
     17f. readings: #1/#2/#5/#6 launches a decode step, host and device ms
               and busy share, unsharded against sharded; then `launch.serve
               --data-shards 2 --shard-devices cuda:0,cuda:0` once.
  18. serving over a "model" axis: llama-200m's first 4 layers through
               `make_serve_mesh(1, 2, devices=["cuda:0"] * 2)` (each linear
               weight's out-features, the embedding's and the head's vocab
               rows split over the two model devices, the rest of each step
               on the first, both on the one card), 4 requests of
               17-49 tokens, 12 new.
     18a. bf16 and quartet2 with prequant over both pools, quartet2 with
               raw weights (each slice quantized per step with the whole
               weight's absmax: #1's given-absmax entry), and (2, 2) on
               ["cuda:0"] * 4 under bf16: every stream bitwise the
               unsharded engine's.
     18b. each model device's split fields byte for byte the slices of
               the whole packed tree's, its resident packed bytes half the
               whole's (the per-matrix gscales each part holds aside).
     18c. #1, #2, #5 and bf16_matmul launches of a full-batch decode step
               at (1, 2) against the counts predicted (MODEL_STEP_LAUNCHES).
     18d. readings: host ms, device ms and busy share of a quartet2 decode
               step at (1, 2), against 17f's unsharded reading. No scaling is claimed: one
               card gains nothing from two model devices.
     18e. bf16_matmul (the port's own kernel) within BF16_MM_BAR of its
               plain version over each row of BF16_MM_ROWS (PERF.md rows
               9-9e: llama-200m's 71 bf16 GEMMs at M = 4, 64, 128 and 352,
               its head at 16,384 rows, nemotron-4-15b's head at 4), a part
               of the rows and the N / 2 halves bitwise the whole call's on
               each row's first 8 calls, timed against torch.matmul (about
               25 s); #2 over a quartet2
               decode step's 70 GEMMs whole and at N / 2 (bitwise the
               whole's halves), #1 given the whole weight's absmax over the
               140 weight halves (bitwise the whole's quantization), timed;
               then `launch.serve --model-shards 2 --shard-devices
               cuda:0,cuda:0` once, the packed bytes by device printed.
Phases run in the order 1, 2, 3, 4, 4b, 6, 5, 7a, 7b, 8, 9, 10, 15, 17, 18,
11, 12, 13, 14, 16 (15, 17 and 18 while phase 4's weights are resident);
the reduced CPU runs that 8b, 8d, 9e and 12e hold the card against run in a
process of their own from the start (`cpu_references`). Then, on their own lines:
the card (nvidia-smi), the kernels JSON, and last
{"ok": true, "device": {...}}. Details also go to chiprun_out/chip_smoke.json.

Imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# rates for the arithmetic each kernel does.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12   # tensor cores: bf16-exact operands, fp32 accumulate (#2, #7)
F32_FLOPS = 67e12     # CUDA cores: the quantizers' and the other attention kernels' f32 math
QUANT_FLOPS_PER_ELEMENT = 14  # 2 branches x (div, round, mul, sub, sq, add) + code
# MS-EDEN phase 1 per element: sign and 1/sqrt(b) multiplies, log2(b) butterfly
# adds, abs/max, the divide, q * denom, two products and two sums
PHASE1_FLOPS_BASE = 10
PHASE2_FLOPS_PER_GROUP = 10  # two divides, a multiply, clips, lattice step, p_up
TRAIN_T = 2048  # tokens of one training step: batch 8 x seq 256

ARCH_SHAPES = {  # (N, K) of the 7 quantized linears of one dense layer
    "wq": (1280, 1280), "wk": (1280, 1280), "wv": (1280, 1280),
    "wo": (1280, 1280), "wi": (3456, 1280), "wg": (3456, 1280),
    "w2": (1280, 3456),
}
REPLACES = {
    "nvfp4_fos_quant": "src/repro/kernels/nvfp4_quant.py:101",
    "fp4_matmul": "src/repro/kernels/fp4_matmul.py:82",
    "paged_gqa": "src/repro/kernels/paged_attention.py:307",
    "ms_eden_phase1": "src/repro/kernels/ms_eden_requant.py:110",
    "ms_eden_phase2": "src/repro/kernels/ms_eden_requant.py:141",
    "paged_gqa_q": "src/repro/kernels/paged_attention.py:345",
    "paged_mla": "src/repro/kernels/paged_attention.py:382",
    "paged_mla_q": "src/repro/kernels/paged_attention.py:421",
    # the port's own: no pallas_call behind it (the reference leaves the
    # bf16 scheme's GEMMs to XLA)
    "bf16_matmul": "none: port-only (src/repro/core/linear.py:_mm, dense)",
}
SERVING_KERNELS = ("nvfp4_fos_quant", "fp4_matmul", "paged_gqa")
# launches of one full-width training step (10 layers x 7 quantized linears;
# the dX GEMM reuses the forward's packed W; phase 2 once per backward GEMM)
TRAIN_LAUNCHES_PER_STEP = {"nvfp4_fos_quant": 140, "fp4_matmul": 210,
                           "ms_eden_phase1": 280, "ms_eden_phase2": 140}
# launches of one full-width nanochat-recipe step (phase 7b): ReLU^2 leaves
# 6 quantized linears a layer, 60 in all; otherwise as above
NANOCHAT_LAUNCHES_PER_STEP = {"nvfp4_fos_quant": 120, "fp4_matmul": 180,
                              "ms_eden_phase1": 240, "ms_eden_phase2": 120}
# launches of the quantization-health probe per site it probes: the weight's
# 4/6 quantization (#1) and its MS-EDEN requant (#3, #4); SR stays plain
PROBE_LAUNCHES_PER_SITE = {"nvfp4_fos_quant": 1, "fp4_matmul": 0,
                           "ms_eden_phase1": 1, "ms_eden_phase2": 1}
PAPER_TABLE1 = {"ms_eden_mse_rel": 9.4e-3, "sr_mse_rel": 23.5e-3}
# phase 7: 7a's run and its async checkpoint period; 7b's recipe run
RESUME_STEPS, RESUME_EVERY = 8, 4
NANOCHAT_STEPS, NANOCHAT_LR, NANOCHAT_PROBE_EVERY = 6, 2e-2, 2
# the probe's card output against the CPU's on one site: its 4/6 and MS-EDEN
# codes come from kernels bitwise their plain versions, SR and the RHT from
# the same hashed draws and f32 ops; only the f32 means sum in another order
PROBE_CPU_RTOL = 1e-5
# the full-width training run of phase 5 (and of tools/quant_probe.py --train)
TRAIN_ARGS = ["--arch", "llama_200m", "--scheme", "quartet2", "--steps", "6",
              "--seq", "256", "--batch", "8", "--lr", "2e-3", "--log-every", "1"]
SOURCES = {
    "nvfp4_fos_quant": "src/repro_torch/kernels/csrc/nvfp4_quant.cu",
    "fp4_matmul": "src/repro_torch/kernels/csrc/fp4_matmul.cu",
    "paged_gqa": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "ms_eden_phase1": "src/repro_torch/kernels/csrc/ms_eden_requant.cu",
    "ms_eden_phase2": "src/repro_torch/kernels/csrc/ms_eden_requant.cu",
    "paged_gqa_q": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_mla": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_mla_q": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "bf16_matmul": "src/repro_torch/kernels/csrc/bf16_matmul.cu",
}
# the CUDA functions each kernel's profiler time is summed over, by a part of
# their names (nvfp4_fos_quant: nvfp4_fos_quant_cluster_kernel, _absmax_kernel,
# _encode_kernel; fp4_matmul: fp4_matmul_gemv_kernel,
# fp4_matmul_splitk_reduce_kernel, fp4_matmul_mma_kernel; paged_gqa and
# paged_gqa_q: paged_gqa_split_kernel, paged_gqa_merge_kernel; paged_mla:
# paged_mla_tc_kernel, paged_mla_merge_kernel; paged_mla_q:
# paged_mla_split_kernel, paged_mla_merge_kernel)
KERNEL_SYMBOLS = {
    "nvfp4_fos_quant": ("nvfp4_fos_quant_",), "fp4_matmul": ("fp4_matmul_",),
    "paged_gqa": ("paged_gqa_",), "ms_eden_phase1": ("ms_eden_phase1_kernel",),
    "ms_eden_phase2": ("ms_eden_phase2_kernel",), "paged_gqa_q": ("paged_gqa_",),
    "paged_mla": ("paged_mla_tc_kernel", "paged_mla_merge_kernel"),
    "paged_mla_q": ("paged_mla_split_kernel", "paged_mla_merge_kernel"),
    "bf16_matmul": ("bf16_matmul_",),
}


def of_kernel(key: str, symbols) -> bool:
    """Whether a profiler row's kernel name holds one of `symbols` (a name
    part, or a tuple of them; "" matches every kernel)."""
    return any(sym in key for sym in ((symbols,) if isinstance(symbols, str)
                                      else symbols))
DEEPSEEK_LAYERS = 2  # the depth cut of phase 6 (see the module docstring)
# (N, K) of deepseek-v3's quantized linears on its decode path: the 4 MLA
# projections and the shared expert at M = 4 rows (4 slots), each routed
# expert at M = 8 (its capacity)
DEEPSEEK_SHAPES = {
    "wq_a": (1536, 7168), "wq_b": (24576, 1536), "wkv_a": (576, 7168),
    "wo": (7168, 16384), "ffn_in": (2048, 7168), "ffn_out": (7168, 2048),
}
DEEPSEEK_LIVE_EXPERTS = 32  # at most 4 tokens x top-8 distinct experts a layer
# live experts in phase 6's two layers at one decode step: 197 quantizer
# calls, the count its profiles show
QUANT_DEEPSEEK_LIVE = (31, 30)


def quant_step_sets(t=TRAIN_T):
    """(M, K, dtype) of every nvfp4_fos_quant call of one step of each path:
    llama-200m decode (4 slots, 10 layers: 6 inputs at K = 1280, 1 at 3456),
    deepseek-v3 decode (2 layers: wq_a, wq_b, wkv_a, wo, the shared expert's
    3 at M = 4, each live routed expert's 3 at M = 8), llama-200m training
    (10 layers: 6 + 1 bf16 activations of T rows, the 7 f32 weights)."""
    llama = ([(4, 1280, "bf16")] * 6 + [(4, 3456, "bf16")]) * 10
    deepseek = []
    for live in QUANT_DEEPSEEK_LIVE:
        deepseek += [(4, 7168, "bf16"), (4, 1536, "bf16"), (4, 7168, "bf16"),
                     (4, 16384, "bf16")]
        deepseek += [(4, 7168, "bf16")] * 2 + [(4, 2048, "bf16")]
        deepseek += [(8, 7168, "bf16"), (8, 7168, "bf16"), (8, 2048, "bf16")] * live
    train = ([(t, 1280, "bf16")] * 6 + [(t, 3456, "bf16")]
             + [(n, k, "f32") for n, k in ARCH_SHAPES.values()]) * 10
    return {"llama_decode": llama, "deepseek_decode": deepseek, "train_step": train}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, symbols, reps: int = 3):
    """The device time of the CUDA functions `symbols` names (see of_kernel)
    per call of fn, from torch.profiler; None when the profiler shows no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0.0) for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA and of_kernel(ev.key, symbols))
    return us / 1e3 / reps if us > 0 else None


def call_device_ms(torch, fn, reps: int = 3, warmup: bool = True):
    """The device time of everything fn launches, per call of fn (the sum of
    every CUDA kernel in the profiler's window), and the launches per call;
    (None, 0) when the profiler shows no device time. One unprofiled call
    first unless `warmup` is False."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA
           and getattr(ev, "self_device_time_total", 0.0) > 0]
    us = sum(ev.self_device_time_total for ev in evs)
    return (us / 1e3 / reps if us > 0 else None,
            sum(ev.count for ev in evs) / reps)


def quant_group(torch, NQ, ops, calls, g, reps, plain_reps=1):
    """One step set of nvfp4_fos_quant calls [(M, K, dtype)] on distinct
    seeded inputs: events time, the whole call's device time (every kernel
    a call launches), kernels launched, plain time and bound (each input
    read once, codes and scale bytes written once)."""
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    xs = [torch.randn((m, k), generator=g, device="cuda").to(dts[dt])
          for m, k, dt in calls]
    fn = lambda: [ops.nvfp4_fos_quant(x) for x in xs]
    dev_ms, kernels = call_device_ms(torch, fn)
    r = {"calls": len(calls), "ms": time_ms(torch, fn, reps),
         "profiler_ms": dev_ms, "kernels_per_call": kernels / len(calls),
         "plain_ms": (time_ms(torch, lambda: [NQ.nvfp4_fos_quant_plain(x) for x in xs],
                              plain_reps, warmup=1) if plain_reps else None),
         "library_ms": None, "library_profiler_ms": None}
    nbytes = sum(x.numel() * (x.element_size() + 0.5 + 1 / 16) + 4 for x in xs)
    n_ops = sum(x.numel() for x in xs) * QUANT_FLOPS_PER_ELEMENT
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, n_ops / F32_FLOPS * 1e3
    r.update(bytes=nbytes, ops=n_ops, bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             regimes=sorted({NQ.plan(m, k).regime for m, k, _ in calls})
             if hasattr(NQ, "plan") else [])
    return r


def finish_results(results, errs):
    """Bound (bytes or operations, whichever is slower), profiler time and
    max error of each timed kernel; logs one line each."""
    import torch
    for name, r in results.items():
        t_bytes = r["bytes"] / HBM_BYTES_S * 1e3
        t_ops = r["ops"] / r["peak"] * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        r["max_abs_err"] = errs[name]
        r["profiler_ms"] = device_ms(torch, r.pop("fn"), KERNEL_SYMBOLS[name])
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        if r.get("library_profiler_ms") is not None:
            lib += f" (profiler {r['library_profiler_ms']:.4f})"
        prof = "n/a" if r["profiler_ms"] is None else f"{r['profiler_ms']:.4f}"
        log(f"  {name:16s} {r['calls']:3d} calls/step: kernel {r['ms']:.4f} ms "
            f"(profiler {prof}), plain {r['plain_ms']:.4f} ms, library {lib} ms, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}: {r['bytes'] / 1e6:.2f} MB, "
            f"{r['ops'] / 1e9:.3f} GFLOP)")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def matmul_bytes_ops(calls, out_bytes):
    """Least bytes (both packed operands and their scales read once, the
    output of out_bytes an element written once, ga and gb) and operations
    (2 M N K) of a list of fp4_matmul calls [(a, w)] or [(a, w, out_bytes)]."""
    nbytes = ops = 0
    for c in calls:
        a, w = c[0], c[1]
        ob = c[2] if len(c) > 2 else out_bytes
        m, n, k = a[0].shape[0], w[0].shape[0], a[0].shape[1] * 2
        nbytes += (m + n) * k * 9 // 16 + m * n * ob + 8
        ops += 2 * m * n * k
    return nbytes, ops


def check_quant(torch, F, NQ, ops, x):
    kern = ops.nvfp4_fos_quant(x)
    torch.cuda.synchronize()
    plain = NQ.nvfp4_fos_quant_plain(x)
    (pk, sk, gk), (pr, sr, gr) = kern, plain
    if not torch.equal(gk, gr) or not torch.equal(sk, sr):
        fail(f"nvfp4_fos_quant {tuple(x.shape)}: scales or gscale differ")

    def ordinal(p):
        c = F.unpack_fp4(p).long()
        return torch.where((c & 8) > 0, -(c & 7), c & 7)
    ok, orr = ordinal(pk), ordinal(pr)
    diff = ok != orr
    frac = diff.double().mean().item()
    step = int((ok - orr).abs().max().item())
    if frac >= 1e-4 or step > 1:
        fail(f"nvfp4_fos_quant {tuple(x.shape)}: code mismatch {frac} step {step}")
    deq = lambda p, s, g: F.fp4_decode(F.unpack_fp4(p)) * torch.repeat_interleave(
        F.bits_to_e4m3(s), F.GROUP, dim=-1) * g
    err = (deq(pk, sk, gk) - deq(pr, sr, gr)).abs().max().item()
    log(f"  nvfp4_fos_quant {str(tuple(x.shape)):14s} {str(x.dtype):15s} "
        f"code mismatch {frac:.2e} (max step {step}), max|d deq| {err:.3g}")
    return err


def check_matmul(torch, FM, ops, a, b):
    """The kernel M picks against the plain version: f32 within 1e-5 of
    max|C| (exact block values; only the f32 summation order differs), and
    the bf16 output bitwise the f32 output rounded to bf16."""
    c = ops.fp4_matmul(a[0], a[1], b[0], b[1], a[2], b[2])
    cb = ops.fp4_matmul(a[0], a[1], b[0], b[1], a[2], b[2], torch.bfloat16)
    torch.cuda.synchronize()
    ref = FM.fp4_matmul_plain(a[0], a[1], b[0], b[1], a[2], b[2])
    err = (c - ref).abs().max().item()
    bar = 1e-5 * ref.abs().max().item()
    shape = (a[0].shape[0], b[0].shape[0], a[0].shape[1] * 2)
    regime = FM.plan(*shape).regime
    cast = torch.equal(cb, c.to(torch.bfloat16))
    log(f"  fp4_matmul (M,N,K)={str(shape):18s} {regime:4s} max|dC| {err:.3g} "
        f"(bar {bar:.3g}); bf16 {'= f32 cast' if cast else 'DIFFERS from the f32 cast'}")
    if not err <= bar or not cast:
        fail(f"fp4_matmul {shape}: {err} > {bar} or bf16 is not the f32 cast")
    return err


def attn_case(torch, b, sq, h, kv, hd, bs, maxb, lens, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_blocks = b * maxb
    perm = torch.randperm(n_blocks, generator=g).tolist()
    table = torch.full((b, maxb), n_blocks, dtype=torch.int32)
    for i, n in enumerate(lens):
        for j in range(-(-n // bs)):
            table[i, j] = perm.pop()
    pos = torch.tensor([n - sq for n in lens], dtype=torch.int32)
    q = torch.randn((b, sq, h, hd), generator=g).bfloat16()
    kp = torch.randn((n_blocks, bs, kv, hd), generator=g).bfloat16()
    vp = torch.randn((n_blocks, bs, kv, hd), generator=g).bfloat16()
    return [t.cuda() for t in (q, kp, vp, table, pos)]


def check_attn(torch, PA, ops, case, name):
    q, kp, vp, table, pos = case
    out = ops.paged_gqa(q, kp, vp, table, pos)
    torch.cuda.synchronize()
    ref = PA.paged_gqa_plain(q, kp, vp, table, pos)
    err = (out - ref).abs().max().item()
    bad = ((out - ref).abs() > 5e-6 + 1e-5 * ref.abs()).double().mean().item()
    log(f"  paged_gqa {name:32s} max|do| {err:.3g}, outside 5e-6/1e-5: {bad:.2e}")
    if bad > 0:
        fail(f"paged_gqa {name}: {bad} of elements outside the bar")
    return err


def attn_bytes_ops(q, kp, vp, table, pos, window=None, kv_row_bytes=None):
    """Least bytes and operations of one paged_gqa call on these inputs: q
    and the output once, and the keys/values each query row needs (under a
    window, those inside the oldest query's window on). kv_row_bytes: the
    bytes of one token's K and V rows (default the bf16 pools'; a packed
    pool's, with vd = hd)."""
    b, sq, h, hd = q.shape
    vd = vp.shape[3] if kv_row_bytes is None else hd
    if kv_row_bytes is None:
        kv_row_bytes = kp.shape[2] * (hd + vd) * 2
    keys = pairs = 0
    for p in pos.tolist():
        lo = 0 if window is None else max(0, p - window + 1)
        keys += max(p + sq - lo, 0)  # keys lo .. newest query
        pairs += sum(p + s + 1 if window is None else min(p + s + 1, window)
                     for s in range(sq))
    nbytes = (q.numel() * q.element_size() + keys * kv_row_bytes
              + table.numel() * 4 + pos.numel() * 4 + b * sq * h * vd * 4)
    ops = pairs * h * (2 * hd + 2 * vd)
    return nbytes, ops


def sdpa_yardstick(torch, q, kp, vp, table, pos, KV, window=None):
    """F.scaled_dot_product_attention over the gathered view (bf16 or
    PackedKV pools), under the causal and the optional window mask (the
    yardstick PyTorch call; never used by the port)."""
    import torch.nn.functional as Fn
    kg = KV.gather_view(kp, table).transpose(1, 2)   # (B, KV, S, hd)
    vg = KV.gather_view(vp, table).transpose(1, 2)
    qt = q.transpose(1, 2)                           # (B, H, Sq, hd)
    sq, s = q.shape[1], kg.shape[2]
    qpos = pos[:, None].long() + torch.arange(sq, device=q.device)[None]
    kj = torch.arange(s, device=q.device)[None, None]
    ok = kj <= qpos[..., None]
    if window is not None:
        ok &= kj > qpos[..., None] - window
    return lambda: Fn.scaled_dot_product_attention(
        qt, kg, vg, attn_mask=ok[:, None], enable_gqa=True)


def phase_kernels(torch):
    from repro_torch.core import formats as F
    from repro_torch.kernels import fp4_matmul as FM
    from repro_torch.kernels import nvfp4_quant as NQ
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.serve import kv_pool as KV

    g = torch.Generator(device="cuda").manual_seed(0)
    errs = {k: 0.0 for k in ("nvfp4_fos_quant", "fp4_matmul", "paged_gqa")}
    log("phase 3: kernels against their plain versions")
    for m in (4, 64):
        for k in (1280, 3456):
            x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
            errs["nvfp4_fos_quant"] = max(errs["nvfp4_fos_quant"],
                                          check_quant(torch, F, NQ, ops, x))
    weights = {}
    for name, (n, k) in ARCH_SHAPES.items():
        w = torch.randn((n, k), generator=g, device="cuda") * k ** -0.5
        errs["nvfp4_fos_quant"] = max(errs["nvfp4_fos_quant"],
                                      check_quant(torch, F, NQ, ops, w))
        weights[name] = ops.nvfp4_fos_quant(w)
    acts = {}
    for m in (1, 4, 8, 16, 17, 64):
        for k in (1280, 3456):
            acts[m, k] = ops.nvfp4_fos_quant(
                torch.randn((m, k), generator=g, device="cuda").bfloat16())
    # the bf16 activations of one training step (T tokens, K = 1280 and 3456)
    for k in (1280, 3456):
        x = torch.randn((TRAIN_T, k), generator=g, device="cuda").bfloat16()
        errs["nvfp4_fos_quant"] = max(errs["nvfp4_fos_quant"],
                                      check_quant(torch, F, NQ, ops, x))
        acts[TRAIN_T, k] = ops.nvfp4_fos_quant(x)
    # both plan regimes at their boundary (the last cluster shape) and one
    # past it, deepseek-v3's decode shapes, and edge inputs in the last chunk
    for m, k in ((4, 2 * NQ.SMALL_MAX_CHUNKS), (4, 2 * NQ.SMALL_MAX_CHUNKS + 16),
                 (8, 7168), (4, 7168), (4, 1536), (8, 2048)):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((m, k), generator=g, device="cuda").to(dt)
            errs["nvfp4_fos_quant"] = max(errs["nvfp4_fos_quant"],
                                          check_quant(torch, F, NQ, ops, x))
    for m, k in ((4, 1280), (2048, 1280)):
        huge = torch.randn((m, k), generator=g, device="cuda")
        huge[-1, -1] = 3e4
        tiny = torch.randn((m, k), generator=g, device="cuda") * 1e-39
        for x in (huge.bfloat16(), huge, tiny, torch.zeros((m, k), device="cuda")):
            errs["nvfp4_fos_quant"] = max(errs["nvfp4_fos_quant"],
                                          check_quant(torch, F, NQ, ops, x))
    # decode and prefill shapes, then every forward GEMM shape of a training
    # step: (T, 1280, 1280), (T, 3456, 1280), (T, 1280, 3456)
    for m in (1, 4, 8, 16, 17, 64, TRAIN_T):
        for name in ("wq", "wi", "w2"):
            w = weights[name]
            errs["fp4_matmul"] = max(errs["fp4_matmul"], check_matmul(
                torch, FM, ops, acts[m, w[0].shape[1] * 2], w))
    # the deepseek-v3 decode shapes: experts at M = 8, the rest at M = 4
    for n, k in DEEPSEEK_SHAPES.values():
        w = ops.nvfp4_fos_quant(torch.randn((n, k), generator=g, device="cuda") * k ** -0.5)
        for m in (8, 4):
            x = ops.nvfp4_fos_quant(torch.randn((m, k), generator=g, device="cuda").bfloat16())
            errs["fp4_matmul"] = max(errs["fp4_matmul"], check_matmul(torch, FM, ops, x, w))
    cases = {
        "llama-200m decode B4 Sq1 H10 KV10": dict(b=4, sq=1, h=10, kv=10, lens=[47, 100, 131, 18]),
        "llama-200m chunk B4 Sq16 H10 KV10": dict(b=4, sq=16, h=10, kv=10, lens=[16, 64, 100, 33]),
        "yi-9b decode B4 Sq1 H32 KV4": dict(b=4, sq=1, h=32, kv=4, lens=[47, 100, 131, 18]),
        "yi-9b chunk B4 Sq16 H32 KV4": dict(b=4, sq=16, h=32, kv=4, lens=[16, 64, 100, 33]),
    }
    for i, (name, c) in enumerate(cases.items()):
        case = attn_case(torch, hd=128, bs=16, maxb=16, seed=i, **c)
        errs["paged_gqa"] = max(errs["paged_gqa"], check_attn(torch, PA, ops, case, name))

    # ---- one decode step's worth of calls (llama-200m, 4 slots, 10 layers)
    log("phase 3: timing one decode step's worth of calls per kernel "
        "(10 layers, distinct weights per layer)")
    layers = 10
    layer_w = [{name: ops.nvfp4_fos_quant(torch.randn(
        (n, k), generator=g, device="cuda") * k ** -0.5)
        for name, (n, k) in ARCH_SHAPES.items()} for _ in range(layers)]
    mm_calls = [(acts[4, w[0].shape[1] * 2], w) for lw in layer_w
                for w in lw.values()]
    blockvals = [(FM.block_values(a[0], a[1]).bfloat16(),
                  FM.block_values(w[0], w[1]).bfloat16().T.contiguous())
                 for a, w in mm_calls]
    attn_layers = [attn_case(torch, b=4, sq=1, h=10, kv=10, hd=128, bs=16,
                             maxb=16, lens=[47, 100, 131, 18], seed=100 + i)
                   for i in range(layers)]
    sdpa_calls = [sdpa_yardstick(torch, *c, KV) for c in attn_layers]

    results = {}
    mm_fn = lambda: [ops.fp4_matmul(a[0], a[1], w[0], w[1], a[2], w[2], torch.bfloat16)
                     for a, w in mm_calls]
    at_fn = lambda: [ops.paged_gqa(*c) for c in attn_layers]
    mm_bytes, mm_ops = matmul_bytes_ops(mm_calls, 2)
    lib_fn = lambda: [torch.matmul(a, w) for a, w in blockvals]
    results["fp4_matmul"] = dict(
        fn=mm_fn, ms=time_ms(torch, mm_fn, 20),
        plain_ms=time_ms(torch, lambda: [FM.fp4_matmul_plain(
            a[0], a[1], w[0], w[1], a[2], w[2], torch.bfloat16) for a, w in mm_calls], 3),
        library_ms=time_ms(torch, lib_fn, 20),
        library_profiler_ms=device_ms(torch, lib_fn, ""),
        bytes=mm_bytes, ops=mm_ops, peak=BF16_FLOPS, calls=len(mm_calls))
    at_bytes, at_ops = map(sum, zip(*(attn_bytes_ops(*c) for c in attn_layers)))
    sdpa_fn = lambda: [f() for f in sdpa_calls]
    results["paged_gqa"] = dict(
        fn=at_fn, ms=time_ms(torch, at_fn, 20),
        plain_ms=time_ms(torch, lambda: [PA.paged_gqa_plain(*c) for c in attn_layers], 3),
        library_ms=time_ms(torch, sdpa_fn, 20),
        library_profiler_ms=device_ms(torch, sdpa_fn, ""),
        bytes=at_bytes, ops=at_ops, peak=F32_FLOPS, calls=len(attn_layers))
    p = PA.plan(4, 1, 10, 10, 16, 16, 128)
    log(f"  paged_gqa plan at the timed shape: {p.splits} splits of "
        f"{p.blocks_per_split} blocks, {p.grid} CTAs, row groups {p.row_groups}")
    finish_results(results, errs)

    # ---- #1 over each path's step: the whole call's device time (every
    # kernel a call launches), distinct inputs in every call
    log("phase 3: nvfp4_fos_quant over one step of each path (llama-200m "
        "decode, deepseek-v3 decode, training), whole calls")
    groups = {}
    for gname, calls in quant_step_sets().items():
        train = gname == "train_step"
        grp = groups[gname] = quant_group(torch, NQ, ops, calls, g, 5 if train else 20,
                                          1 if train else 3)
        log(f"  {gname:16s} {grp['calls']:3d} calls ({'+'.join(grp['regimes'])}, "
            f"{grp['kernels_per_call']:.2f} kernels a call): events {grp['ms']:.4f} ms, "
            f"device {grp['profiler_ms']} ms, plain {grp['plain_ms']:.3f} ms, bound "
            f"{grp['bound_ms']:.5f} ms ({grp['bound_by']}: {grp['bytes'] / 1e6:.2f} MB)")
    q = results["nvfp4_fos_quant"] = dict(groups.pop("llama_decode"))
    q["groups"] = groups
    q["max_abs_err"] = errs["nvfp4_fos_quant"]
    torch.cuda.empty_cache()
    return results


def matmul_group(torch, FM, ops, calls, reps, plain_reps=1):
    """Events, profiler, plain and library (torch.matmul on the bf16 block
    values) times and the bound of one list of fp4_matmul calls [(a, w,
    out_dtype)]; the block values (GBs) exist only while the library runs."""
    fn = lambda: [ops.fp4_matmul(a[0], a[1], w[0], w[1], a[2], w[2], dt)
                  for a, w, dt in calls]
    r = {"calls": len(calls), "ms": time_ms(torch, fn, reps)}
    r["profiler_ms"] = device_ms(torch, fn, KERNEL_SYMBOLS["fp4_matmul"])
    r["plain_ms"] = time_ms(torch, lambda: [FM.fp4_matmul_plain(
        a[0], a[1], w[0], w[1], a[2], w[2], dt) for a, w, dt in calls],
        plain_reps, warmup=1)
    vals = [(FM.block_values(a[0], a[1]).bfloat16(),
             FM.block_values(w[0], w[1]).bfloat16().T.contiguous()) for a, w, _ in calls]
    lib_fn = lambda: [torch.matmul(a, w) for a, w in vals]
    lib = r["library_ms"] = time_ms(torch, lib_fn, reps)
    r["library_profiler_ms"] = device_ms(torch, lib_fn, "")
    del vals, lib_fn
    nbytes, n_ops = matmul_bytes_ops(
        [(a, w, 2 if dt == torch.bfloat16 else 4) for a, w, dt in calls], 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, n_ops / BF16_FLOPS * 1e3
    r.update(bytes=nbytes, ops=n_ops, bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             regimes=sorted({FM.plan(a[0].shape[0], w[0].shape[0],
                                     a[0].shape[1] * 2).regime for a, w, _ in calls}))
    prof = "n/a" if r["profiler_ms"] is None else f"{r['profiler_ms']:.4f}"
    log(f"  {len(calls)} calls ({'+'.join(r['regimes'])}): kernel {r['ms']:.4f} ms "
        f"(profiler {prof}), plain {r['plain_ms']:.3f} ms, library {lib:.4f} ms "
        f"(profiler {r['library_profiler_ms']}), "
        f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}: {nbytes / 1e6:.1f} MB, "
        f"{n_ops / 1e9:.1f} GFLOP)")
    return r


def phase_matmul_groups(torch):
    """fp4_matmul over one deepseek-v3 decode step's calls and over one
    full-width llama-200m training step's 210 GEMMs, distinct operands in
    every call, as the main paths give them."""
    from repro_torch.core import rht as R
    from repro_torch.core import rng
    from repro_torch.kernels import fp4_matmul as FM
    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(11)
    quant = lambda shape, scale=1.0: ops.nvfp4_fos_quant(
        torch.randn(shape, generator=g, device="cuda") * scale)
    groups = {}
    log(f"phase 3: fp4_matmul over one deepseek-v3 decode step ({DEEPSEEK_LAYERS} "
        f"layers: 4 MLA projections and the shared expert at M = 4, "
        f"{DEEPSEEK_LIVE_EXPERTS} live experts x 3 at M = 8; bf16 out)")
    acts = {(m, k): ops.nvfp4_fos_quant(torch.randn(
        (m, k), generator=g, device="cuda").bfloat16())
        for m in (4, 8) for k in (1536, 2048, 7168, 16384)}
    calls = []
    for _ in range(DEEPSEEK_LAYERS):
        per_layer = [(4, DEEPSEEK_SHAPES[nm]) for nm in ("wq_a", "wq_b", "wkv_a", "wo")]
        per_layer += [(4, DEEPSEEK_SHAPES[nm]) for nm in ("ffn_in", "ffn_in", "ffn_out")]
        per_layer += [(8, DEEPSEEK_SHAPES[nm]) for _ in range(DEEPSEEK_LIVE_EXPERTS)
                      for nm in ("ffn_in", "ffn_in", "ffn_out")]
        for m, (n, k) in per_layer:
            calls.append((acts[m, k], quant((n, k), k ** -0.5), torch.bfloat16))
    groups["deepseek_decode"] = matmul_group(torch, FM, ops, calls, 10)
    del calls
    torch.cuda.empty_cache()

    log(f"phase 3: fp4_matmul over one training step's 210 GEMMs (T = {TRAIN_T}: "
        "the forward on 4/6 operands, bf16 out; dX and dW on MS-EDEN operands, f32)")
    draws = rng.HashDraws([11, 3])

    def requant(shape, tag):
        x = torch.randn(shape, generator=g, device="cuda")
        d = shape[1]
        return ops.ms_eden_requant(x, draws.signs(tag, R.block_size(d), "cuda"),
                                   draws.uniform(tag + 1, (shape[0], d // 16), "cuda"))
    calls = []
    for _ in range(10):
        for n, k in ARCH_SHAPES.values():
            calls.append((quant((TRAIN_T, k)), quant((n, k), k ** -0.5), torch.bfloat16))
            calls.append((requant((TRAIN_T, n), 1), requant((k, n), 3), torch.float32))
            calls.append((requant((n, TRAIN_T), 5), requant((k, TRAIN_T), 7), torch.float32))
    groups["train_step"] = matmul_group(torch, FM, ops, calls, 3)
    del calls
    torch.cuda.empty_cache()
    return groups


def backward_gemms(t):
    """The (Ma, Mb, D) of the backward GEMMs of one dense layer at T tokens:
    per quantized linear (N, K), dX = E (T, N) . W^T (K, N) and
    dW = E^T (N, T) . X^T (K, T)."""
    shapes = []
    for n, k in ARCH_SHAPES.values():
        shapes += [(t, k, n), (n, k, t)]
    return sorted(set(shapes))


def requant_operands(t):
    """The 28 requant operand shapes of one dense layer's backward at T
    tokens: per quantized linear (N, K), E (T, N) and W^T (K, N) of the dX
    GEMM, E^T (N, T) and X^T (K, T) of the dW GEMM."""
    shapes = []
    for n, k in ARCH_SHAPES.values():
        shapes += [(t, n), (k, n), (n, t), (k, t)]
    return shapes


def check_phase1(torch, MR, ops, x, signs):
    """Phase 1 bitwise against its plain version on the same x (a contiguous
    tensor or a view, read in place)."""
    kern = ops.ms_eden_phase1(x, signs)
    torch.cuda.synchronize()
    plain = MR.phase1_plain(x, signs)
    codes_equal = torch.equal(kern[0], plain[0])
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(kern[1:], plain[1:]))
    kind, ld = MR.layout(x)
    log(f"  ms_eden_phase1 {str(tuple(x.shape)):14s} {kind} (ld {ld}) codes "
        f"{'equal' if codes_equal else 'DIFFER'}, max|d| of pseudo/num/den/"
        f"absmax {err:.3g}")
    if not codes_equal or err != 0:
        fail(f"ms_eden_phase1 {tuple(x.shape)} {kind}: not bitwise equal to its "
             "plain version")
    return plain


def backward_operands(torch, g, t):
    """The 28 requant operands of one dense layer's backward at T tokens, as
    `core.linear._bwd_gemm` hands them: per quantized linear (N, K), E (T, N)
    row-major, and the transposed views W^T (K, N), E^T (N, T), X^T (K, T)
    of W (N, K), E and X (T, K) (the order of `requant_operands`)."""
    ops_ = []
    for n, k in ARCH_SHAPES.values():
        e = torch.randn((t, n), generator=g, device="cuda")
        w = torch.randn((n, k), generator=g, device="cuda") * k ** -0.5
        x = torch.randn((t, k), generator=g, device="cuda")
        ops_ += [e, w.T, e.T, x.T]
    return ops_


def check_phase2(torch, F, MR, ops, p1, draws, tag):
    """Phase 2 bitwise against its plain version on the tag's uniforms, both
    hashed in the kernel from the tag's key pair and read from a uniforms
    tensor (HashDraws.uniform, the same on the card as on the CPU)."""
    u = draws.uniform(tag, p1[1].shape, "cuda")
    plain = MR.phase2_plain(p1[4], p1[1], p1[2], p1[3], u)
    err = 0.0
    for mode, arg in (("hashed", draws.keys(tag)), ("uniforms", u)):
        kern = ops.ms_eden_phase2(p1[4], p1[1], p1[2], p1[3], arg)
        torch.cuda.synchronize()
        err = max(err, (F.bits_to_e4m3(kern[0]) - F.bits_to_e4m3(plain[0])).abs().max().item(),
                  abs(float(kern[1]) - float(plain[1])))
        if not (torch.equal(kern[0], plain[0]) and torch.equal(kern[1], plain[1])):
            fail(f"ms_eden_phase2 {tuple(u.shape)} ({mode}): not bitwise equal to "
                 "its plain version")
    if not torch.equal(u.cpu(), draws.uniform(tag, p1[1].shape, "cpu")):
        fail(f"HashDraws.uniform {tuple(u.shape)}: the card's draws differ from the CPU's")
    log(f"  ms_eden_phase2 {str(tuple(u.shape)):14s} hashed and uniforms: max|d scale| "
        f"{err:.3g}, gscale {float(plain[1]):.6g}")
    return err


def check_phase2_pair(torch, MR, ops, pa, pb, draws, tag):
    """One phase-2 launch over both operands of a backward GEMM (operand a
    hashed, operand b on a uniforms tensor, then both hashed): bitwise the
    plain version of each."""
    ua = draws.uniform(tag, pa[1].shape, "cuda")
    ub = draws.uniform(tag + 1, pb[1].shape, "cuda")
    want = [MR.phase2_plain(pa[4], *pa[1:4], ua), MR.phase2_plain(pb[4], *pb[1:4], ub)]
    for arg_b in (ub, draws.keys(tag + 1)):
        got = ops.ms_eden_phase2_batch([(pa[4], *pa[1:4], draws.keys(tag)),
                                        (pb[4], *pb[1:4], arg_b)])
        torch.cuda.synchronize()
        for (bits, gs), (wb, wg) in zip(got, want):
            if not (torch.equal(bits, wb) and torch.equal(gs, wg)):
                fail(f"ms_eden_phase2 over two operands {tuple(pa[1].shape)}, "
                     f"{tuple(pb[1].shape)}: not bitwise equal to the plain version")


def check_backward_gemm(torch, draws, a, b):
    """The backward GEMM a @ b^T on the card against its plain composition
    (phase 1, phase 2 and the GEMM's plain versions) within 1e-3 of max|C|,
    bitwise the same on hashed uniforms as on the same uniforms as tensors;
    and fp4_matmul on its requant operands (`check_matmul`, whose error is
    returned). a and b may be views, as the backward hands them."""
    from repro_torch.core import rht as R
    from repro_torch.kernels import fp4_matmul as FM
    from repro_torch.kernels import ms_eden_requant as MR
    from repro_torch.kernels import ops
    (ma, d), mb = a.shape, b.shape[0]
    signs = draws.signs(1, R.block_size(d), "cuda")
    ua = draws.uniform(2, (ma, d // 16), "cuda")
    ub = draws.uniform(3, (mb, d // 16), "cuda")
    mm_err = check_matmul(torch, FM, ops, ops.ms_eden_requant(a, signs, ua),
                          ops.ms_eden_requant(b, signs, ub))
    c = ops.quartet2_backward_gemm(a, b, signs, ua, ub)
    c_keys = ops.quartet2_backward_gemm(a, b, signs, draws.keys(2), draws.keys(3))
    torch.cuda.synchronize()
    if not torch.equal(c, c_keys):
        fail(f"quartet2_backward_gemm ({ma},{mb},{d}): hashed uniforms differ "
             "from the same uniforms as tensors")
    qa, qb = MR.phase1_plain(a, signs), MR.phase1_plain(b, signs)
    sa = MR.phase2_plain(qa[4], *qa[1:4], ua)
    sb = MR.phase2_plain(qb[4], *qb[1:4], ub)
    ref = FM.fp4_matmul_plain(qa[0], sa[0], qb[0], sb[0], sa[1], sb[1])
    err = (c - ref).abs().max().item()
    bar = 1e-3 * ref.abs().max().item()
    exact = (a @ b.T)
    rel = ((c - exact).norm() / exact.norm()).item()
    log(f"  quartet2_backward_gemm (Ma,Mb,D)=({ma},{mb},{d}): max|dC| vs plain "
        f"composition {err:.3g} (bar {bar:.3g}); relative error vs the "
        f"exact f32 product {rel:.4f}")
    if not err <= bar:
        fail(f"quartet2_backward_gemm ({ma},{mb},{d}): {err} > {bar}")
    return mm_err


def phase_requant(torch):
    """Kernels #3/#4 against their plain versions at the training shapes, the
    backward GEMM against its plain composition, and the time of the 280
    requant calls of one full-width training step."""
    from repro_torch.core import formats as F
    from repro_torch.core import rht as R
    from repro_torch.core import rng
    from repro_torch.kernels import fp4_matmul as FM
    from repro_torch.kernels import ms_eden_requant as MR
    from repro_torch.kernels import ops

    log("phase 3: MS-EDEN requant kernels against their plain versions "
        f"(training shapes at T = {TRAIN_T}; bitwise)")
    g = torch.Generator(device="cuda").manual_seed(7)
    draws = rng.HashDraws([7, 7])
    errs = {"ms_eden_phase1": 0.0, "ms_eden_phase2": 0.0}
    shapes = sorted(set(requant_operands(TRAIN_T)))
    shapes += [(1000, 1280), (256, 1280), (96, 48)]  # odd M, zeros, b = 16
    p1s = {}
    for i, (m, k) in enumerate(shapes):
        x = torch.randn((m, k), generator=g, device="cuda")
        if (m, k) == (256, 1280):
            x.zero_()
        signs = draws.signs(i, R.block_size(k), "cuda")
        p1s[m, k] = check_phase1(torch, MR, ops, x, signs)
        errs["ms_eden_phase2"] = max(errs["ms_eden_phase2"], check_phase2(
            torch, F, MR, ops, p1s[m, k], draws, 100 + i))
    # both operands of each backward GEMM shape in one launch
    for i, (ma, mb, d) in enumerate(backward_gemms(TRAIN_T)):
        check_phase2_pair(torch, MR, ops, p1s[ma, d], p1s[mb, d], draws, 150 + 2 * i)
    log(f"  ms_eden_phase2 over both operands of each of the {len(backward_gemms(TRAIN_T))} "
        "backward GEMM shapes in one launch (hashed / uniforms): bitwise")
    del p1s
    # every operand as the backward hands it (transposed views read in
    # place), and transposes whose M is no multiple of 4 (4-byte chunks)
    seen = set()
    for x in backward_operands(torch, g, TRAIN_T) + [
            torch.randn((80, 33), generator=g, device="cuda").T,
            torch.randn((48, 1000), generator=g, device="cuda").T]:
        key = (tuple(x.shape), x.stride())
        if key not in seen:
            seen.add(key)
            check_phase1(torch, MR, ops, x, draws.signs(len(seen), R.block_size(
                x.shape[1]), "cuda"))
    # every dX and dW GEMM shape of a training step: the backward GEMM
    # against its plain composition, and fp4_matmul on its requant operands
    mm_err = 0.0
    for ma, mb, d in backward_gemms(TRAIN_T):
        a = torch.randn((ma, d), generator=g, device="cuda")
        b = torch.randn((mb, d), generator=g, device="cuda")
        mm_err = max(mm_err, check_backward_gemm(torch, draws, a, b))

    # ---- one full-width training step's requant: 280 phase-1 calls on the
    # operands as the backward hands them (E row-major; W^T, E^T, X^T views),
    # and phase 2 once per backward GEMM (dX: E, W^T; dW: E^T, X^T) on
    # hashed uniforms, 140 launches
    log("phase 3: timing one training step's worth of requant calls "
        f"(10 layers x 28 operands as _bwd_gemm hands them, T = {TRAIN_T}; "
        "phase 2 over both operands of each of the 140 backward GEMMs)")
    calls = [x for _ in range(10) for x in backward_operands(torch, g, TRAIN_T)]
    signs = draws.signs(0, 128, "cuda")
    p1s = [ops.ms_eden_phase1(x, signs) for x in calls]
    keys = [draws.keys(200 + i) for i in range(len(p1s))]
    pairs = [[(p1s[i + j][4], *p1s[i + j][1:4], keys[i + j]) for j in (0, 1)]
             for i in range(0, len(p1s), 2)]
    n_el = sum(x.numel() for x in calls)
    n_groups = n_el // 16
    results = {}
    p1_fn = lambda: [ops.ms_eden_phase1(x, signs) for x in calls]
    p2_fn = lambda: [ops.ms_eden_phase2_batch(pair) for pair in pairs]
    results["ms_eden_phase1"] = dict(
        fn=p1_fn, ms=time_ms(torch, p1_fn, 5),
        plain_ms=time_ms(torch, lambda: [MR.phase1_plain(x, signs) for x in calls], 1,
                         warmup=1),
        library_ms=None, bytes=n_el * (4 + 0.5 + 12 / 16) + len(calls) * (4 + 512),
        ops=n_el * (PHASE1_FLOPS_BASE + 7), peak=F32_FLOPS, calls=len(calls))
    # 13 bytes a group (pseudo, num, den read; the scale byte written), the
    # absmax read and the gscale written per operand
    results["ms_eden_phase2"] = dict(
        fn=p2_fn, ms=time_ms(torch, p2_fn, 5),
        plain_ms=time_ms(torch, lambda: [MR.phase2_plain(*op) for pair in pairs
                                         for op in pair], 1, warmup=1),
        library_ms=None, bytes=n_groups * 13 + len(calls) * 8,
        ops=n_groups * PHASE2_FLOPS_PER_GROUP, peak=F32_FLOPS, calls=len(pairs))
    finish_results(results, errs)
    # what the step paid before: the 280 uniform tensors drawn by
    # HashDraws.uniform (PyTorch int64 kernels), then one phase-2 launch
    # per operand reading them (17 bytes a group)
    r = results["ms_eden_phase2"]
    shapes = [p[1].shape for p in p1s]
    draw_fn = lambda: [draws.uniform(200 + i, sh, "cuda") for i, sh in enumerate(shapes)]
    us = draw_fn()
    one_fn = lambda: [ops.ms_eden_phase2(p[4], p[1], p[2], p[3], u)
                      for p, u in zip(p1s, us)]
    draws_dev, draws_launches = call_device_ms(torch, draw_fn)
    t_bytes = (n_groups * 17 + len(calls) * 8) / HBM_BYTES_S * 1e3
    r["groups"] = {"one_operand_uniforms": dict(
        calls=len(calls), ms=time_ms(torch, one_fn, 5),
        profiler_ms=device_ms(torch, one_fn, KERNEL_SYMBOLS["ms_eden_phase2"]),
        plain_ms=r["plain_ms"], library_ms=None, library_profiler_ms=None,
        bound_ms=max(t_bytes, r["ops"] / F32_FLOPS * 1e3), bound_by="bytes")}
    r["draws"] = {"calls": len(shapes), "ms": time_ms(torch, draw_fn, 5),
                  "profiler_ms": draws_dev, "launches": draws_launches}
    one = r["groups"]["one_operand_uniforms"]
    log(f"  ms_eden_phase2 as before, one operand a launch on uniforms tensors: "
        f"{one['calls']} launches {one['ms']:.4f} ms (profiler {one['profiler_ms']}); "
        f"the {len(shapes)} uniform draws it read: {r['draws']['ms']:.4f} ms "
        f"(profiler {draws_dev}, {draws_launches:g} PyTorch launches)")
    del us
    # the same 280 calls on contiguous copies of the operands (what phase 1
    # read before it took views; the copies themselves are not timed)
    flat = [x.contiguous() for x in calls]
    flat_fn = lambda: [ops.ms_eden_phase1(x, signs) for x in flat]
    r = results["ms_eden_phase1"]
    r["contiguous_ms"] = time_ms(torch, flat_fn, 5)
    r["contiguous_profiler_ms"] = device_ms(torch, flat_fn, KERNEL_SYMBOLS["ms_eden_phase1"])
    log(f"  ms_eden_phase1 on contiguous copies of the same operands: "
        f"{r['contiguous_ms']:.4f} ms (profiler {r['contiguous_profiler_ms']})")
    del calls, p1s, pairs, flat
    torch.cuda.empty_cache()
    return results, mm_err


def paged_table(torch, g, b, maxb, bs, lens, dead=()):
    """A (b, maxb) block table over b * maxb pool blocks, randomly placed;
    dead rows hold only the sentinel."""
    n_blocks = b * maxb
    perm = torch.randperm(n_blocks, generator=g).tolist()
    table = torch.full((b, maxb), n_blocks, dtype=torch.int32)
    for i, n in enumerate(lens):
        if i not in dead:
            for j in range(-(-n // bs)):
                table[i, j] = perm.pop()
    return table, n_blocks


def gqa_q_case(torch, F, b, sq, h, kv, hd, bs, maxb, lens, dead=(), seed=0,
               packed=True, scale=3.0):
    """(q, k codes, k scales, v codes, v scales, table, pos) on the card, or
    with packed=False (q, k, v, table, pos) over the same draws in bf16; K
    and V are `scale` x unit normals."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    table, n_blocks = paged_table(torch, g, b, maxb, bs, lens, dead)
    pos = torch.tensor([max(n - sq, 0) for n in lens], dtype=torch.int32)
    q = torch.randn((b, sq, h, hd), generator=g).bfloat16()
    k, v = ((torch.randn((n_blocks, bs, kv, hd), generator=g) * scale).bfloat16()
            for _ in range(2))
    pools = ((*F.nvfp4_cache_encode(k), *F.nvfp4_cache_encode(v)) if packed
             else (k, v))
    return [t.cuda() for t in (q, *pools, table, pos)]


def mla_case(torch, F, b, sq, bs, maxb, lens, packed, dead=(), seed=0,
             h=128, lora=512, rope=64):
    """(q_abs f32, q_rope bf16, latent pool leaves..., table, pos) on the
    card at deepseek-v3's widths: (cc, kc) bf16, or their codes and scale
    bits when packed."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    table, n_blocks = paged_table(torch, g, b, maxb, bs, lens, dead)
    pos = torch.tensor([max(n - sq, 0) for n in lens], dtype=torch.int32)
    qa = torch.randn((b, sq, h, lora), generator=g) * 0.1
    qr = torch.randn((b, sq, h, rope), generator=g).bfloat16()
    cc = torch.randn((n_blocks, bs, lora), generator=g).bfloat16()
    kc = (torch.randn((n_blocks, bs, rope), generator=g) * 2).bfloat16()
    pools = ((*F.nvfp4_cache_encode(cc), *F.nvfp4_cache_encode(kc)) if packed
             else (cc, kc))
    return [t.cuda() for t in (qa, qr, *pools, table, pos)]


def check_against_plain(torch, name, out, ref, dead, label):
    """The attention bar: |out - ref| <= 5e-6 + 1e-5 |ref|; dead rows 0."""
    err = (out - ref).abs().max().item()
    bad = ((out - ref).abs() > 5e-6 + 1e-5 * ref.abs()).double().mean().item()
    zeros = all(int((out[r] != 0).sum()) == 0 for r in dead)
    log(f"  {name} {label:38s} max|do| {err:.3g}, outside 5e-6/1e-5: {bad:.2e}"
        f"{', inactive rows exactly 0' if dead else ''}")
    if bad > 0 or not zeros:
        fail(f"{name} {label}: outside the bar ({bad}) or a nonzero inactive row")
    return err


def keys_and_pairs(pos, sq):
    """Cache rows each batch row reads (positions 0 .. its newest query) and
    (query, key) pairs attended, from this run's positions."""
    keys = sum(int(p) + sq for p in pos)
    pairs = sum(int(p) + s + 1 for p in pos for s in range(sq))
    return keys, pairs


def gather_sdpa(torch, q, k, v, pos, scale=None):
    """F.scaled_dot_product_attention over already-gathered views (the
    yardstick PyTorch call; never used by the port): q (B, Sq, H, d), k/v
    (B, T, KV, d) with KV dividing H."""
    import torch.nn.functional as Fn
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sq, t = q.shape[1], k.shape[1]
    qpos = pos[:, None].long() + torch.arange(sq, device=q.device)[None]
    mask = (torch.arange(t, device=q.device)[None, None] <= qpos[..., None])[:, None]
    return lambda: Fn.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                   scale=scale, enable_gqa=True)


def phase_paged_q_mla(torch):
    """Kernels #6 (packed GQA), #7 (MLA) and #8 (packed MLA) against their
    plain versions, then one decode step's calls of each timed."""
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.serve import kv_pool as KV

    log("phase 3: packed GQA and MLA decode kernels against their plain versions")
    errs = {"paged_gqa_q": 0.0, "paged_mla": 0.0, "paged_mla_q": 0.0}
    gqa_cases = {
        "llama-200m decode B4 Sq1 H10 KV10": dict(sq=1, lens=[47, 100, 131, 18], dead=(3,)),
        "llama-200m chunk B4 Sq16 H10 KV10": dict(sq=16, lens=[16, 64, 100, 33]),
    }
    for i, (label, c) in enumerate(gqa_cases.items()):
        q, kc, ks, vc, vs, table, pos = gqa_q_case(
            torch, F, b=4, h=10, kv=10, hd=128, bs=16, maxb=16, seed=i, **c)
        out = ops.paged_gqa_q(q, kc, ks, vc, vs, table, pos)
        torch.cuda.synchronize()
        ref = PA.paged_gqa_q_plain(q, kc, ks, vc, vs, table, pos)
        errs["paged_gqa_q"] = max(errs["paged_gqa_q"], check_against_plain(
            torch, "paged_gqa_q", out, ref, c.get("dead", ()), label))
    mla_cases = {
        "deepseek-v3 decode B4 Sq1 H128": dict(sq=1, lens=[47, 100, 1, 64], dead=(2,)),
        "deepseek-v3 chunk B4 Sq16 H128": dict(sq=16, lens=[16, 64, 100, 33], dead=(3,)),
        "deepseek-v3 decode B4 Sq1 4,096 tokens": dict(sq=1, lens=[4096] * 4, maxb=256),
        "Sq16, scratch cap binds (3 splits)": dict(b=2, sq=16, lens=[1000, 517],
                                                   maxb=64, dead=()),
    }
    for packed, name in ((False, "paged_mla"), (True, "paged_mla_q")):
        for i, (label, c) in enumerate(mla_cases.items()):
            c = {"b": 4, "maxb": 16, **c}
            args = mla_case(torch, F, bs=16, packed=packed, seed=10 + i,
                            **{k: v for k, v in c.items() if k != "dead"},
                            dead=c.get("dead", ()))
            kern = ops.paged_mla_q if packed else ops.paged_mla
            plain = PA.paged_mla_q_plain if packed else PA.paged_mla_plain
            out = kern(*args, qk_dim=192)
            again = kern(*args, qk_dim=192)
            torch.cuda.synchronize()
            errs[name] = max(errs[name], check_against_plain(
                torch, name, out, plain(*args, 192), c.get("dead", ()), label))
            if not torch.equal(out, again):
                fail(f"{name} {label}: two calls on the same inputs differ")
            del args, out, again

    # ---- one decode step's calls: llama-200m (10 layers) for #6, phase 6's
    # deepseek-v3 (2 layers) for #7 and #8; 4 slots
    log("phase 3: timing one decode step's calls (llama-200m: 10 layers, "
        f"4 slots; deepseek-v3: {DEEPSEEK_LAYERS} layers, 4 slots)")
    results = {}
    gl = [gqa_q_case(torch, F, b=4, sq=1, h=10, kv=10, hd=128, bs=16, maxb=16,
                     lens=[47, 100, 131, 18], seed=100 + i) for i in range(10)]
    sd = []
    nbytes = ops_n = 0
    for q, kc, ks, vc, vs, table, pos in gl:
        kg = KV.gather_view(KV.PackedKV(kc, ks), table)
        vg = KV.gather_view(KV.PackedKV(vc, vs), table)
        sd.append(gather_sdpa(torch, q, kg, vg, pos))
        keys, pairs = keys_and_pairs(pos.tolist(), 1)
        nbytes += (q.numel() * 2 + keys * 10 * 256 * 0.5625 + table.numel() * 4
                   + pos.numel() * 4 + q.numel() * 4)
        ops_n += pairs * 10 * (2 * 128 + 2 * 128)
    fn = lambda: [ops.paged_gqa_q(*c) for c in gl]
    sdpa_fn = lambda sd=sd: [f() for f in sd]
    results["paged_gqa_q"] = dict(
        fn=fn, ms=time_ms(torch, fn, 20),
        plain_ms=time_ms(torch, lambda: [PA.paged_gqa_q_plain(*c) for c in gl], 3),
        library_ms=time_ms(torch, sdpa_fn, 20),
        library_profiler_ms=device_ms(torch, sdpa_fn, ""),
        bytes=nbytes, ops=ops_n, peak=F32_FLOPS, calls=len(gl))
    lens = [40, 57, 72, 25]  # phase 6's prompts of 16-64 tokens, mid-decode
    for packed, name in ((False, "paged_mla"), (True, "paged_mla_q")):
        results[name] = mla_step_group(torch, F, PA, ops, KV, packed, lens, 16, 20,
                                       seed=200)
    finish_results(results, errs)
    log(f"phase 3: #7 and #8 over one deepseek-v3 decode step ({DEEPSEEK_LAYERS} "
        "layers) at 4 rows x 4,096 tokens")
    for packed, name in ((False, "paged_mla"), (True, "paged_mla_q")):
        grp = mla_step_group(torch, F, PA, ops, KV, packed, [4096] * 4, 256, 5,
                             seed=400, plain_reps=1)
        finish_results({name: grp}, errs)
        results[name]["groups"] = {"4x4096": grp}
        torch.cuda.empty_cache()
    return results


def mla_step_group(torch, F, PA, ops, KV, packed, lens, maxb, reps, seed,
                   plain_reps=3, sq=1):
    """One deepseek-v3 decode step's #7 (packed=False) or #8 calls (one a
    layer, 4 rows of `lens` tokens over a (4, maxb) table, Sq queries a
    row: 1 to decode, 16 for a prefill chunk): the timing
    dict finish_results completes. The yardstick is SDPA over the gathered
    latent view (q and k the latent and rope parts side by side, v the
    latent part); the bound counts the cache rows each row reads and the
    (query, key) pairs it scores, the operations at the bf16 tensor-core
    peak for #7 (its products run there) and the f32 one for #8."""
    calls = [mla_case(torch, F, b=4, sq=sq, bs=16, maxb=maxb, lens=lens,
                      packed=packed, seed=seed + i)
             for i in range(DEEPSEEK_LAYERS)]
    kern = ops.paged_mla_q if packed else ops.paged_mla
    plain = PA.paged_mla_q_plain if packed else PA.paged_mla_plain
    sd = []
    nbytes = ops_n = 0
    for c in calls:
        qa, qr, table, pos = c[0], c[1], c[-2], c[-1]
        pools = ((KV.PackedKV(c[2], c[3]), KV.PackedKV(c[4], c[5])) if packed
                 else (c[2], c[3]))
        cv, kv = (KV.gather_view(p, table).float() for p in pools)
        qcat = torch.cat([qa, qr.float()], -1)
        kcat = torch.cat([cv, kv], -1)[:, :, None]
        sd.append(gather_sdpa(torch, qcat, kcat, cv[:, :, None], pos,
                              scale=PA.mla_scale(192)))
        keys, pairs = keys_and_pairs(pos.tolist(), sq)
        row = 576 * (0.5625 if packed else 2)
        nbytes += (qa.numel() * 4 + qr.numel() * 2 + keys * row
                   + table.numel() * 4 + pos.numel() * 4 + qa.numel() * 4)
        ops_n += pairs * 128 * (2 * 576 + 2 * 512)
    fn = lambda: [kern(*c, qk_dim=192) for c in calls]
    sdpa_fn = lambda: [f() for f in sd]
    return dict(
        fn=fn, ms=time_ms(torch, fn, reps),
        plain_ms=(time_ms(torch, lambda: [plain(*c, 192) for c in calls], plain_reps,
                          warmup=1) if plain_reps else None),
        library_ms=time_ms(torch, sdpa_fn, reps),
        library_profiler_ms=device_ms(torch, sdpa_fn, ""),
        bytes=nbytes, ops=ops_n, peak=F32_FLOPS if packed else BF16_FLOPS,
        calls=len(calls))


def phase_gqa_splits(torch):
    """#5 and #6, the split-KV kernels, on cases that stress the splits:
    against their plain versions under the attention bar, and two calls
    bitwise equal. yi-9b's grouped heads run over the NVFP4 pool (phase 3's
    bf16 cases hold them over the bf16 pool at unit scale; at this data's 3x
    scale the plain version's own f32 error reaches the bar there, which
    tools/gqa_split_probe.py measures against float64), the rest over both
    pools. Returns the max error of each kernel."""
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA

    log(f"phase 3: split-KV GQA decode (splits of {PA.SPLIT_KEYS} keys) on both "
        "pools, two calls bitwise equal")
    cases = {
        "yi-9b decode B4 Sq1 H32 KV4": dict(b=4, sq=1, h=32, kv=4, maxb=16,
                                            lens=[47, 100, 131, 18], dead=(3,),
                                            pools=(True,)),
        "yi-9b chunk B4 Sq16 H32 KV4": dict(b=4, sq=16, h=32, kv=4, maxb=16,
                                            lens=[16, 64, 100, 33], pools=(True,)),
        "maxb 64, a 1,024-token row": dict(b=4, sq=1, h=10, kv=10, maxb=64,
                                           lens=[1024, 517, 31, 300], dead=(2,)),
        "ends on a split edge, +1, Sq 1": dict(b=4, sq=1, h=10, kv=10, maxb=16,
                                               lens=[32, 33, 64, 65]),
        "ends on a split edge, +1, Sq 16": dict(b=4, sq=16, h=10, kv=10, maxb=16,
                                                lens=[32, 33, 64, 65]),
        "window 40: whole splits dead": dict(b=4, sq=1, h=10, kv=10, maxb=64,
                                             lens=[1024, 200, 41, 90], window=40),
        "window 50, Sq 16, yi-9b heads": dict(b=2, sq=16, h=32, kv=4, maxb=16,
                                              lens=[256, 70], window=50,
                                              pools=(True,)),
    }
    errs = {"paged_gqa": 0.0, "paged_gqa_q": 0.0}
    for i, (label, c) in enumerate(cases.items()):
        c = dict(c)
        window = c.pop("window", None)
        for packed in c.pop("pools", (False, True)):
            name = "paged_gqa_q" if packed else "paged_gqa"
            args = gqa_q_case(torch, F, hd=128, bs=16, seed=300 + i,
                              packed=packed, **c)
            kern = ops.paged_gqa_q if packed else ops.paged_gqa
            plain = PA.paged_gqa_q_plain if packed else PA.paged_gqa_plain
            out = kern(*args, window=window)
            again = kern(*args, window=window)
            torch.cuda.synchronize()
            errs[name] = max(errs[name], check_against_plain(
                torch, name, out, plain(*args, window=window), c.get("dead", ()),
                label))
            if not torch.equal(out, again):
                fail(f"{name} {label}: two calls on the same inputs differ")
    return errs


def phase_train_reference(torch, arch="llama_200m"):
    """A quartet2 train step at reduced size, the card against the CPU: same
    weights, batches and hashed draws; only fp32 summation orders differ."""
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.models import lm
    from repro_torch.train.train_step import make_train_step

    cfg = registry.get(arch).reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(4), "cpu")
    corpus = SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=64, global_batch=4, d_model=cfg.d_model,
        emit_embeds=cfg.input_mode == "embeds"))
    losses = {}
    for d in ("cpu", "cuda"):
        init, step = make_train_step(cfg, "quartet2", base_lr=2e-3, total_steps=3)
        state = init(to_device(params, d))
        seq = []
        for i in range(3):
            state, m = step(state, {k: v.to(d) for k, v in corpus.batch_at(i).items()})
            seq.append(float(m["loss"]))
        losses[d] = seq
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    log(f"  reduced {cfg.name} quartet2 train step x3: card {losses['cuda']} vs "
        f"CPU {losses['cpu']}: max relative difference {worst:.3g}")
    # the same numbers up to fp32 summation order: 1e-3 of the loss
    if not all(map(lambda v: v == v, losses["cuda"])) or worst > 1e-3:
        fail(f"reduced {cfg.name} quartet2 train step: card disagrees with the CPU")
    return {"card": losses["cuda"], "cpu": losses["cpu"], "max_rel": worst}


def to_device(tree, d):
    """A copy of a tree of tensors on device d (training updates in place)."""
    if isinstance(tree, dict):
        return {k: to_device(v, d) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, d) for v in tree]
    if isinstance(tree, tuple):  # a PackedQWeight, or a pair of trees
        vals = [to_device(v, d) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree.to(d, copy=True)


def phase_small_reference(torch):
    """The paged step at reduced size: kernels on the card against the plain
    versions on the CPU, same weights and tokens: llama-200m (bf16 pool) and
    deepseek-v3 (MLA + MoE; the bf16 and the NVFP4 latent pool)."""
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.serve import decode as serve_decode
    from repro_torch.serve.kv_pool import KVPool
    from repro_torch.serve.prequant import prequantize

    for arch, kv_quant in (("llama_200m", False), ("deepseek_v3_671b", False),
                           ("deepseek_v3_671b", True)):
        cfg = registry.get(arch).reduced()
        params = lm.init(cfg, torch.Generator().manual_seed(1), "cpu")
        toks = torch.randint(0, cfg.vocab, (2, 20),
                             generator=torch.Generator().manual_seed(2),
                             dtype=torch.int32)
        pool_name = "NVFP4 pool" if kv_quant else "bf16 pool"
        for scheme in ("bf16", "quartet2"):
            outs = {}
            for d in ("cpu", "cuda"):
                p = prequantize(to_device(params, d), cfg, scheme)
                pool = KVPool(cfg, 2, 32, block_size=16, device=d,
                              quantized=kv_quant)
                for s in range(2):
                    pool.commit(s, 20)
                    pool.ensure(s, 20)
                step = serve_decode.make_paged_serve_step(cfg, scheme)
                seq = []
                for start, size in ((0, 16), (16, 1), (17, 1), (18, 1)):
                    lg, _ = step(p, pool.caches, pool.tables_device(),
                                 toks[:, start:start + size].to(d),
                                 torch.full((2,), start, dtype=torch.int32, device=d),
                                 torch.ones(2, dtype=torch.bool, device=d))
                    seq.append(lg.float().cpu())
                outs[d] = seq
            worst_abs = max((a - b).abs().max().item()
                            for a, b in zip(outs["cuda"], outs["cpu"]))
            worst_rel = max(((a - b).pow(2).mean() / b.pow(2).mean()).sqrt().item()
                            for a, b in zip(outs["cuda"], outs["cpu"]))
            finite = all(torch.isfinite(a).all() for a in outs["cuda"])
            log(f"  reduced {cfg.name} paged step ({pool_name}), {scheme}: card vs "
                f"CPU max|dlogit| {worst_abs:.3g}, rel RMS {worst_rel:.3g}")
            # bf16: the sums differ in order only; quartet2: below the ~0.3
            # relative error that quantization itself adds at this size
            if not finite or (scheme == "bf16" and worst_abs > 2e-2) or worst_rel > 0.3:
                fail(f"reduced paged step ({arch}, {pool_name}, {scheme}): card "
                     "disagrees with the CPU")


# --------------------------------------------------------------------------
# phase 4: serving through ServeEngine at full width
# --------------------------------------------------------------------------

def serve_once(torch, cfg, params, EngineConfig, Request, ServeEngine, prompts,
               max_new, **econf_kw):
    econf = EngineConfig(**{**dict(n_slots=4, max_len=256, block_size=16,
                                   prefill_chunk=16, scheme="quartet2",
                                   prequant=True, device="cuda"), **econf_kw})
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, econf)
    cuda_sync(torch, econf.device)
    setup_s = time.perf_counter() - t0
    for p in prompts:
        eng.submit(Request(p, max_new))
    t0 = time.perf_counter()
    results = eng.run()
    cuda_sync(torch, econf.device)
    return eng, results, setup_s, time.perf_counter() - t0


def served(torch, cfg, eng, results, prompts, max_new, launches, kernels):
    """Checks every serving run shares: all requests served with in-vocabulary
    tokens, every pool block free, each path kernel launched."""
    if sorted(r.req_id for r in results) != list(range(len(prompts))):
        fail(f"served {len(results)} of {len(prompts)} requests")
    if any(len(r.tokens) != max_new for r in results):
        fail("a request returned the wrong number of tokens")
    if not all(0 <= t < cfg.vocab for r in results for t in r.tokens):
        fail("token ids outside the vocabulary")
    if eng.pool.free_block_count != eng.pool.n_blocks:
        fail(f"{eng.pool.n_blocks - eng.pool.free_block_count} pool blocks leaked")
    if any(launches[k] <= 0 for k in kernels):
        fail(f"a kernel was not launched on the serving path: {launches}")


def serving_numbers(results, st, setup_s, wall, peak, launches):
    ttft = sorted(r.ttft_s for r in results)
    return {
        "setup_s": setup_s, "wall_s": wall,
        "decode_tok_s": st["decode_tokens"] / st["decode_s"],
        "decode_step_ms": st["decode_s"] / st["decode_steps"] * 1e3,
        "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
        "ttft_s_median": ttft[len(ttft) // 2], "ttft_s_max": ttft[-1],
        "decode_steps": st["decode_steps"], "prefill_steps": st["prefill_steps"],
        "peak_mem_bytes": peak, "launches": launches,
    }


def pool_byte_ratio(pool):
    """Bytes of the pool's token leaves over the bytes of bf16 leaves of the
    same logical shape."""
    from repro_torch.serve.kv_pool import PackedKV
    held = bf16 = 0
    for stage in pool.caches:
        for kinds in stage.values():
            for leaves in kinds.values():
                for leaf in leaves:
                    if isinstance(leaf, PackedKV):
                        held += leaf.codes.numel() + leaf.scales.numel()
                        bf16 += leaf.codes.numel() * 2 * 2
                    else:
                        held += leaf.numel() * leaf.element_size()
                        bf16 += leaf.numel() * 2
    return held / bf16


def llama_weights(torch):
    """Full-width llama-200m weights from seed 0, drawn once and shared by
    phases 4, 4b and 8."""
    from repro_torch.configs import registry
    from repro_torch.models import lm
    cfg = registry.get("llama_200m")
    return lm.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")


def phase_serving(torch, card, params, kv_quant=False):
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    pool_name = "NVFP4 pool" if kv_quant else "paged bf16 pool"
    log(f"phase {'4b' if kv_quant else '4'}: serving full-width llama-200m "
        f"(quartet2, prequant, {pool_name}, 4 slots)")
    cfg = registry.get("llama_200m")
    g = torch.Generator().manual_seed(3)
    lens = torch.randint(16, 101, (8,), generator=g).tolist()
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist() for n in lens]
    # warm-up run (first launches, allocator, cuBLAS handles), not measured
    serve_once(torch, cfg, params, EngineConfig, Request, ServeEngine,
               prompts[:2], 4, kv_quant=kv_quant)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    eng, results, setup_s, wall = serve_once(
        torch, cfg, params, EngineConfig, Request, ServeEngine, prompts, 32,
        kv_quant=kv_quant)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    attn = "paged_gqa_q" if kv_quant else "paged_gqa"
    served(torch, cfg, eng, results, prompts, 32, launches,
           ("nvfp4_fos_quant", "fp4_matmul", attn))
    ratio = pool_byte_ratio(eng.pool)
    if kv_quant and (launches["paged_gqa"] != 0 or ratio != 0.28125):
        fail(f"kv_quant serving: paged_gqa launched {launches['paged_gqa']} "
             f"times, pool bytes {ratio} of bf16 (want 0 and 0.28125)")
    out = {"prompt_lens": lens, "prompts": prompts, "pool_bytes_over_bf16": ratio,
           **serving_numbers(results, eng.stats, setup_s, wall, peak, launches),
           "launches_per_decode_step": None,
           "streams": {r.req_id: r.tokens for r in results}}
    # launches of one decode step at full batch, counted on one tick
    fill_decode(eng, Request, prompts, 12)
    ops.reset_launches()
    eng.step()
    out["launches_per_decode_step"] = dict(ops.LAUNCHES)
    eng.run()
    # the logits of one full-width decode step are finite and shaped (4, 1, V)
    import numpy as np
    logits = eng._forward(np.zeros((4, 1), np.int32), np.zeros(4, np.int32),
                          np.zeros(4, bool))
    if tuple(logits.shape) != (4, 1, cfg.vocab) or not torch.isfinite(logits).all():
        fail("full-width logits are not finite of shape (4, 1, vocab)")
    log(f"  [{card}] 8 requests x 32 tokens: decode {out['decode_tok_s']:.1f} tok/s "
        f"({out['decode_step_ms']:.2f} ms/step), prefill {out['prefill_tok_s']:.1f} tok/s, "
        f"TTFT median {out['ttft_s_median'] * 1e3:.1f} ms max {out['ttft_s_max'] * 1e3:.1f} ms, "
        f"peak memory {peak / 2**30:.2f} GiB, wall {wall:.2f} s, pool bytes "
        f"{ratio:.5f} of bf16")
    log(f"  launches on the main path: {launches}; per decode step: "
        f"{out['launches_per_decode_step']}")
    out["profile"] = profile_decode(torch, eng, Request, prompts)
    return out


def phase_deepseek(torch, card):
    """Phase 6: deepseek-v3 at its published widths, 2 layers, quartet2,
    weights packed as drawn, served with the bf16 and the NVFP4 latent
    pool. Returns its numbers, the config and the packed weights (phase 8
    serves them again)."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    from repro_torch.serve.prequant import init_packed

    t_phase = time.perf_counter()
    # depth cut only: every layer of this config is MLA + MoE, so 2 layers
    # are two whole periods; 61 layers of 6.54 GB packed (plus the 7.4 GB
    # f32 embedding and head) do not fit one 80 GB card. Widths, heads,
    # experts and vocabulary are the published ones.
    cfg = dataclasses.replace(registry.get("deepseek_v3_671b"),
                              n_layers=DEEPSEEK_LAYERS)
    log(f"phase 6: serving deepseek-v3 at full width, {cfg.n_layers} layers "
        "(quartet2, weights packed as drawn, 4 slots)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_packed(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "quartet2", "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    weight_bytes = torch.cuda.memory_allocated()
    log(f"  weights drawn and packed in {init_s:.1f} s: {weight_bytes / 2**30:.2f} GiB "
        f"resident, init peak {init_peak / 2**30:.2f} GiB")
    g = torch.Generator().manual_seed(6)
    lens = torch.randint(16, 65, (4,), generator=g).tolist()
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist() for n in lens]
    out = {"prompt_lens": lens, "init_s": init_s, "init_peak_bytes": init_peak,
           "weight_bytes": weight_bytes}
    for kv_quant in (False, True):
        pool_name = "nvfp4_pool" if kv_quant else "bf16_pool"
        attn = "paged_mla_q" if kv_quant else "paged_mla"
        kw = dict(kv_quant=kv_quant, prequant=False)  # packed already
        serve_once(torch, cfg, params, EngineConfig, Request, ServeEngine,
                   prompts[:1], 2, **kw)  # warm-up, not measured
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        eng, results, setup_s, wall = serve_once(
            torch, cfg, params, EngineConfig, Request, ServeEngine, prompts, 16,
            **kw)
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        served(torch, cfg, eng, results, prompts, 16, launches,
               ("nvfp4_fos_quant", "fp4_matmul", attn))
        other = "paged_mla" if kv_quant else "paged_mla_q"
        if launches[other] or launches["paged_gqa"] or launches["paged_gqa_q"]:
            fail(f"deepseek-v3 ({pool_name}) launched another attention kernel: "
                 f"{launches}")
        r = serving_numbers(results, eng.stats, setup_s, wall, peak, launches)
        r["pool_bytes_over_bf16"] = pool_byte_ratio(eng.pool)
        r["streams"] = {res.req_id: res.tokens for res in results}
        fill_decode(eng, Request, prompts, 12)
        ops.reset_launches()
        eng.step()
        r["launches_per_decode_step"] = dict(ops.LAUNCHES)
        eng.run()
        log(f"  [{card}] {pool_name}: 4 requests x 16 tokens: decode "
            f"{r['decode_tok_s']:.2f} tok/s ({r['decode_step_ms']:.1f} ms/step host), "
            f"prefill {r['prefill_tok_s']:.1f} tok/s, TTFT median "
            f"{r['ttft_s_median']:.2f} s max {r['ttft_s_max']:.2f} s, peak memory "
            f"{peak / 2**30:.2f} GiB, wall {wall:.1f} s")
        log(f"  launches on the main path: {launches}; per decode step: "
            f"{r['launches_per_decode_step']}")
        r["profile"] = profile_decode(torch, eng, Request, prompts)
        out[pool_name] = r
        del eng
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 6 took {out['phase_s']:.1f} s")
    return out, cfg, params


def fill_decode(eng, Request, prompts, max_new):
    """Admit 4 short requests and tick until every slot decodes (each has
    room for at least 8 more decode steps)."""
    for p in prompts[:4]:
        eng.submit(Request(p[:16], max_new))
    while any(s.state != "decode" for s in eng.slots):
        eng.step()


def profile_decode(torch, eng, Request, prompts, steps: int = 8):
    """Device time by kernel over `steps` decode steps at full batch
    (torch.profiler), and the device's busy share: device time per step
    over the host-clock time of `steps` full-batch decode steps run just
    before them without the profiler (whose own host overhead inflates the
    wall time of a traced step)."""
    from torch.profiler import ProfilerActivity, profile
    fill_decode(eng, Request, prompts, 2 * steps + 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    eng.run()
    from torch.autograd import DeviceType
    rows = []
    total_us = 0.0
    for ev in prof.key_averages():  # device-side events only (no CPU ops)
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
            total_us += dev_us
    rows.sort(reverse=True)
    if total_us == 0:
        log("  profile: no device time in key_averages() (not measured)")
        return None
    dev_step_ms = total_us / 1e3 / steps
    busy = dev_step_ms / step_ms
    log(f"  profile of {steps} full-batch decode steps: device time {dev_step_ms:.3f} "
        f"ms/step against a {step_ms:.2f} ms step (host clock, unprofiled): busy "
        f"{busy:.1%}, idle {1 - busy:.1%}; device time per step by kernel:")
    for us, key, n in rows[:10]:
        log(f"    {us / 1e3 / steps:8.4f} ms  {n // steps:4d}x  {key[:90]}")
    # each port kernel's device ms per step (paged_gqa and paged_gqa_q share
    # their CUDA functions; a path runs one of them)
    by_kernel = {name: sum(us for us, key, _ in rows if of_kernel(key, sym)) / 1e3
                 / steps for name, sym in KERNEL_SYMBOLS.items()}
    log("    port kernels, ms per step: " + ", ".join(
        f"{name} {ms:.4f}" for name, ms in by_kernel.items() if ms > 0))
    torch_ops = launches_by_pattern(rows, steps)
    log("    PyTorch launches per step: " + ", ".join(
        f"{p} {n:g} ({ms:.4f} ms)" for p, (n, ms) in torch_ops.items()))
    return {"device_ms_per_step": dev_step_ms, "host_ms_per_step": step_ms,
            "busy_share": busy, "kernel_ms": by_kernel, "torch_launches": torch_ops,
            "top": [(key, us / 1e3 / steps, n // steps) for us, key, n in rows[:12]]}


# PyTorch kernels the quantizer's wrapper used to launch (AbsFunctor, the
# amax's reduce_kernel), the copies that fed MS-EDEN phase 1, and kernels
# with "long" in their names: the int64 functors of the hashed draws
# (core/rng.py), and also every kernel that takes an int64 size
TORCH_PATTERNS = ("AbsFunctor", "reduce_kernel", "copy_kernel", "long")


def launches_by_pattern(rows, steps):
    """{pattern: (launches, device ms)} per step over profile rows (us, key,
    count) whose kernel name holds the pattern."""
    return {p: (sum(n for _, key, n in rows if p in key) / steps,
                sum(us for us, key, _ in rows if p in key) / 1e3 / steps)
            for p in TORCH_PATTERNS}


def phase_training(torch, card):
    """Full-width llama-200m trained for 6 steps through the entry point's
    code path; then one more step under the profiler."""
    from repro_torch.core import rng
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw

    steps = int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
    log(f"phase 5: training full-width llama-200m (quartet2, AdamW, cosine, "
        f"lr 2e-3, batch 8 x seq 256, {steps} steps)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # every SR uniform tensor HashDraws draws during the run (phase 2 takes
    # key pairs and hashes the uniforms itself: there should be none)
    drawn, real_uniform = [], rng.HashDraws.uniform

    def counted_uniform(self, tag, shape, device):
        drawn.append(tuple(shape))
        return real_uniform(self, tag, shape, device)

    rng.HashDraws.uniform = counted_uniform
    ops.reset_launches()
    try:
        out, trainer, state = launch_train.run(TRAIN_ARGS)
        torch.cuda.synchronize()
    finally:
        rng.HashDraws.uniform = real_uniform
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    if not all(h["finite"] for h in trainer.history):
        fail(f"non-finite training loss: {losses}")
    if not all(bool(torch.isfinite(p).all()) for p in adamw.leaves(state.params)):
        fail("non-finite parameters after training")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall: {losses}")
    want = {k: v * steps for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"training launches {got}, expected {want}")
    if drawn:
        fail(f"{len(drawn)} SR uniform tensors drawn on the training path, e.g. "
             f"{drawn[:3]}")
    log(f"  [{card}] losses {[round(x, 4) for x in losses]}; "
        f"{out['step_ms']:.1f} ms/step (host clock, steps 2-{steps}), "
        f"{out['tokens_per_s']:.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB")
    log(f"  launches on the training path: {launches}; SR uniform tensors drawn: 0")
    prof = profile_train_step(torch, trainer, state, out["step_ms"])
    return {"losses": losses, "step_ms": out["step_ms"],
            "step_ms_all": [h["dt"] * 1e3 for h in trainer.history],
            "tokens_per_s": out["tokens_per_s"], "peak_mem_bytes": peak,
            "launches": launches, "profile": prof}


def profile_train_step(torch, trainer, state, step_ms, say=log, batch=None):
    """Device time by kernel of one training step (torch.profiler) on
    `batch` (by default the corpus's batch of the state's step), and the
    device's busy share against the unprofiled host-clock step time; `say`
    logs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if batch is None:
        batch = {k: v.cuda() for k, v in trainer.corpus.batch_at(state.step).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
    rows, total_us = [], 0.0
    for ev in prof.key_averages():
        # gloo's "gloo:all_reduce" range of a CUDA tensor reads as a device
        # row holding its own host-to-device copy's time, which has its row
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("gloo:"):
            continue
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
            total_us += dev_us
    rows.sort(reverse=True)
    if total_us == 0:
        say("  profile: no device time in key_averages() (not measured)")
        return None
    dev_ms = total_us / 1e3
    n_launches = sum(n for _, _, n in rows)
    busy = dev_ms / step_ms
    say(f"  profile of one training step: device time {dev_ms:.2f} ms against a "
        f"{step_ms:.1f} ms step: busy {busy:.1%}, idle {1 - busy:.1%}; by kernel:")
    for us, key, n in rows[:12]:
        say(f"    {us / 1e3:9.3f} ms  {n:5d}x  {key[:90]}")
    by_kernel = {}
    for name in ("fp4_matmul", "nvfp4_fos_quant", "ms_eden_phase1", "ms_eden_phase2"):
        by_kernel[name] = sum(us for us, key, _ in rows
                              if of_kernel(key, KERNEL_SYMBOLS[name])) / 1e3
    say("  device ms per training step by ported kernel: " + ", ".join(
        f"{k} {v:.3f}" for k, v in by_kernel.items()))
    torch_ops = launches_by_pattern(rows, 1)
    say(f"  kernel launches per training step: {n_launches} in all; PyTorch: " + ", ".join(
        f"{p} {n:g} ({ms:.3f} ms)" for p, (n, ms) in torch_ops.items()))
    return {"device_ms_per_step": dev_ms, "busy_share": busy, "launches": n_launches,
            "kernel_ms": by_kernel, "torch_launches": torch_ops,
            "top": [(key, us / 1e3, n) for us, key, n in rows[:16]]}


# --------------------------------------------------------------------------
# phase 7: pre-training as users run it
# --------------------------------------------------------------------------

def host_leaves(torch, state):
    """Host copies of every leaf of a training state, in checkpoint order."""
    from repro_torch.checkpoint import checkpointer as C
    return [x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x
            for x in C.flatten(C.reference_tree(state))]


def same_leaves(torch, a, b) -> bool:
    return len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(a, b))


def max_rel_diff(torch, a, b) -> float:
    """The largest max|x - y| / max|y| over paired tensors."""
    return max(float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
               for x, y in zip(a, b))


def train_setup(torch, cfg, optimizer, schedule, lr, total, seed=0):
    """(train_step, freshly built full-width state on the card): seeded
    random weights, the same for every call with the same seed."""
    from repro_torch.models import lm
    from repro_torch.train.train_step import make_train_step
    init, step = make_train_step(cfg, "quartet2", optimizer=optimizer,
                                 schedule=schedule, base_lr=lr, total_steps=total)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return step, init(lm.init(cfg, gen, "cuda"))


def nondeterministic_ops(torch, step, state, batch):
    """The ops of one training step that PyTorch reports as having no
    deterministic CUDA implementation (use_deterministic_algorithms with
    warn_only: each such op warns, naming itself)."""
    import warnings
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            step(state, batch)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(".")[0][:160] for w in seen
                   if "determinis" in str(w.message)})


def phase_resume(torch, card):
    """7a: a full-width llama-200m quartet2 run (AdamW) checkpointed async
    every RESUME_EVERY steps, resumed from its mid checkpoint by a fresh
    Trainer over freshly built state, against the run itself and against
    an uninterrupted repeat."""
    import os
    import shutil
    import tempfile
    from repro_torch.checkpoint import checkpointer as C
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = registry.get("llama_200m")
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=256, global_batch=8))
    # the reference's rule saves after the step of index RESUME_EVERY: its
    # state has taken RESUME_EVERY + 1 steps, and the checkpoint is labelled so
    mid = RESUME_EVERY + 1
    log(f"phase 7a: resume (full-width llama-200m, quartet2, AdamW, batch 8 x seq "
        f"256, {RESUME_STEPS} steps, async checkpoint every {RESUME_EVERY}: "
        f"labelled {mid}, keep 1)")
    step, state = train_setup(torch, cfg, "adamw", "cosine", 2e-3, RESUME_STEPS)
    # f32 on disk: every tensor leaf at 4 bytes an element
    ckpt_bytes = sum(x.numel() * 4 if isinstance(x, torch.Tensor) else 4
                     for x in C.flatten(C.reference_tree(state)))
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free = shutil.disk_usage(root).free
    # at most two checkpoints on disk at once: the one resumed from and a new one
    if free < 2.1 * ckpt_bytes:
        shutil.rmtree(root, ignore_errors=True)
        fail(f"phase 7a needs {2.1 * ckpt_bytes / 1e9:.2f} GB free under {root} for "
             f"two {ckpt_bytes / 1e9:.2f} GB checkpoints; {free / 1e9:.2f} GB free")
    dir_a, dir_r = os.path.join(root, "a"), os.path.join(root, "resume")
    try:
        tr_a = Trainer(TrainerConfig(total_steps=RESUME_STEPS, ckpt_dir=dir_a,
                                     ckpt_every=RESUME_EVERY, keep_ckpts=1,
                                     log_every=1), step, corpus,
                       device=torch.device("cuda"))
        ck, snap, saves = tr_a.ckpt, {}, []
        real_save, real_gc = ck.save, ck._gc

        def save(s, st, extra=None, blocking=True):
            if s == mid:  # the host snapshot check 1 holds the restore to
                snap["leaves"] = host_leaves(torch, st)
            t0 = time.perf_counter()
            real_save(s, st, extra, blocking)
            saves.append({"step": s, "blocking": blocking,
                          "call_s": time.perf_counter() - t0, "last": ck.last})

        def gc_keeping_mid():
            # hard-link the mid checkpoint aside before keep=1 removes it
            src = os.path.join(dir_a, f"step_{mid:010d}")
            dst = os.path.join(dir_r, f"step_{mid:010d}")
            if os.path.isdir(src) and not os.path.exists(dst):
                os.makedirs(dst)
                for f in os.listdir(src):
                    os.link(os.path.join(src, f), os.path.join(dst, f))
            real_gc()

        ck.save, ck._gc = save, gc_keeping_mid
        ops.reset_launches()
        state = tr_a.run(state)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        a_losses = [h["loss"] for h in tr_a.history]
        a_dt = [h["dt"] * 1e3 for h in tr_a.history]
        a_final = [p.detach().cpu() for p in adamw.leaves(state.params)]
        if sorted(os.listdir(dir_a)) != [f"step_{RESUME_STEPS:010d}"]:
            fail(f"run A left {sorted(os.listdir(dir_a))} (keep 1)")
        mid_save = next((s for s in saves if s["step"] == mid), None)
        if mid_save is None or mid_save["blocking"] or "leaves" not in snap:
            fail(f"run A made no async save at step {mid}: {saves}")
        del state, tr_a
        shutil.rmtree(dir_a)
        torch.cuda.empty_cache()

        # the resumed run: a fresh Trainer and freshly built state
        step, state = train_setup(torch, cfg, "adamw", "cosine", 2e-3, RESUME_STEPS)
        check1 = {}

        def step_r(st, batch):
            if not check1:  # the state exactly as Trainer.run restored it
                check1["step"] = st.step
                check1["equal"] = same_leaves(torch, host_leaves(torch, st),
                                              snap["leaves"])
            return step(st, batch)

        tr_r = Trainer(TrainerConfig(total_steps=RESUME_STEPS, ckpt_dir=dir_r,
                                     ckpt_every=RESUME_EVERY, keep_ckpts=1,
                                     log_every=1), step_r, corpus,
                       device=torch.device("cuda"))
        t0 = time.perf_counter()
        state = tr_r.run(state, resume=True)
        torch.cuda.synchronize()
        r_wall = time.perf_counter() - t0
        r_losses = [h["loss"] for h in tr_r.history]
        r_final = [p.detach().cpu() for p in adamw.leaves(state.params)]
        del state, tr_r
        snap.clear()
        torch.cuda.empty_cache()
        if check1.get("step") != mid or not check1["equal"]:
            fail(f"check 1: the restored state is not bitwise the host snapshot "
                 f"of step {mid}: {check1}")
        if r_losses[0] != a_losses[mid]:
            fail(f"check 2: the resumed run's first loss {r_losses[0]!r} is not "
                 f"run A's {a_losses[mid]!r} at step {mid}")

        # run B: the uninterrupted repeat of A, and the ops that may differ
        step, state = train_setup(torch, cfg, "adamw", "cosine", 2e-3, RESUME_STEPS)
        tr_b = Trainer(TrainerConfig(total_steps=RESUME_STEPS, log_every=100),
                       step, corpus, device=torch.device("cuda"))
        state = tr_b.run(state)
        torch.cuda.synchronize()
        b_losses = [h["loss"] for h in tr_b.history]
        b_final = [p.detach().cpu() for p in adamw.leaves(state.params)]
        batch = {k: v.cuda() for k, v in corpus.batch_at(state.step).items()}
        nondet = nondeterministic_ops(torch, step, state, batch)
        del state, tr_b
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    ab_equal = a_losses == b_losses and same_leaves(torch, a_final, b_final)
    r_tail = a_losses[mid:]
    if ab_equal:
        # the card is deterministic here: the resumed run must be bitwise A
        if r_losses != r_tail or not same_leaves(torch, r_final, a_final):
            fail(f"check 3: A and its repeat agree bitwise but the resumed run "
                 f"does not: losses {r_losses} vs {r_tail}")
        bar = "bitwise"
    else:
        # hold the resumed run to the spread between A and its repeat
        loss_spread = max(abs(a - b) for a, b in zip(a_losses, b_losses))
        w_spread = max_rel_diff(torch, b_final, a_final)
        r_loss = max(abs(a - b) for a, b in zip(r_losses, r_tail))
        r_w = max_rel_diff(torch, r_final, a_final)
        if r_loss > loss_spread or r_w > w_spread:
            fail(f"check 3: the resumed run differs from A by {r_loss:.3g} in loss "
                 f"and {r_w:.3g} in weights, beyond A's repeat ({loss_spread:.3g}, "
                 f"{w_spread:.3g}); ops without a deterministic implementation: "
                 f"{nondet}")
        bar = (f"within A's own repeat spread (loss {loss_spread:.3g}, weights "
               f"{w_spread:.3g} max|w|; resumed {r_loss:.3g}, {r_w:.3g})")
    last = mid_save["last"]
    log(f"  [{card}] run A losses {[round(x, 4) for x in a_losses]}")
    log(f"  async save at step {mid}: save() blocked the host {mid_save['call_s'] * 1e3:.1f} "
        f"ms (device-to-host copy {last['copy_s'] * 1e3:.1f} ms, the first save: "
        f"its pinned buffers allocated); the write took "
        f"{last['write_s']:.2f} s on its thread, {last['bytes'] / 1e9:.3f} GB on disk "
        f"({last['bytes'] / last['write_s'] / 1e9:.2f} GB/s); step ms around it: "
        + ", ".join(f"{i}: {t:.1f}" for i, t in enumerate(a_dt)))
    final_save = next(s for s in saves if s["step"] == RESUME_STEPS)
    log(f"  final blocking save at step {RESUME_STEPS}: {final_save['call_s']:.2f} s, "
        f"of which the device-to-host copy into the pinned buffers the first "
        f"save made {final_save['last']['copy_s'] * 1e3:.1f} ms")
    log(f"  resumed at step {mid} in {r_wall:.1f} s (restore included): check 1 "
        f"(restored leaves == host snapshot) bitwise; check 2 (first loss) "
        f"{r_losses[0]!r} == {a_losses[mid]!r}; check 3: {bar}")
    log(f"  A == its uninterrupted repeat B bitwise: {ab_equal}; ops without a "
        f"deterministic CUDA implementation in one step: {nondet or 'none reported'}")
    out = {"a_losses": a_losses, "b_losses": b_losses, "r_losses": r_losses,
           "a_step_ms": a_dt, "mid": mid, "ckpt_bytes_est": ckpt_bytes,
           "save_block_ms": mid_save["call_s"] * 1e3,
           "final_copy_ms": final_save["last"]["copy_s"] * 1e3,
           "copy_ms": last["copy_s"] * 1e3, "write_s": last["write_s"],
           "bytes_on_disk": last["bytes"], "final_save_s": final_save["call_s"],
           "resume_wall_s": r_wall, "a_equals_b": ab_equal, "check3": bar,
           "nondeterministic_ops": nondet, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    log(f"  phase 7a took {out['phase_s']:.1f} s")
    return out


def probe_site_vs_cpu(torch, params, step):
    """The probe over one site on the card and on the CPU, same weights,
    step and seed: {metric: (card, cpu)}."""
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.quant_probe import QuantProbe
    name, leaf = QuantProbe.sites(params)[0]
    outs = []
    for d in ("cuda", "cpu"):
        path = name.split("/")  # "[0]/l0/ff/wi": rebuild that one site
        tree = {"stages": [{path[1]: {path[2]: {path[3]: leaf.detach().to(d)}}}]}
        probe = QuantProbe("quartet2", every_n=NANOCHAT_PROBE_EVERY, max_sites=1,
                           registry=MetricsRegistry())
        outs.append(probe.probe_params(tree, step=step)[name])
    return name, {m: (outs[0][m], outs[1][m]) for m in outs[0]}


def phase_nanochat(torch, card):
    """7b: the paper's nanochat recipe at llama-200m's widths (QK-norm,
    ReLU^2, Muon, WSD), quartet2, with the quantization-health probe
    attached."""
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.quant_probe import QuantProbe
    from repro_torch.optim import adamw, muon
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(registry.get("llama_200m"), qk_norm=True, mlp="relu2")
    steps = NANOCHAT_STEPS
    log(f"phase 7b: the nanochat recipe (llama-200m widths, QK-norm, ReLU^2, quartet2, "
        f"Muon, WSD, lr {NANOCHAT_LR}, batch 8 x seq 256, {steps} steps), "
        f"QuantProbe(every_n={NANOCHAT_PROBE_EVERY})")
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=256, global_batch=8))
    step, state = train_setup(torch, cfg, "muon", "wsd", NANOCHAT_LR, steps, seed=1)
    probe = QuantProbe("quartet2", every_n=NANOCHAT_PROBE_EVERY,
                       registry=MetricsRegistry())
    samples, real_probe = [], probe.probe_params

    def probe_params(params, step=0, phase="train"):
        out = real_probe(params, step=step, phase=phase)
        samples.append((step, out))
        return out

    probe.probe_params = probe_params
    tr = Trainer(TrainerConfig(total_steps=steps, log_every=1), step, corpus,
                 device=torch.device("cuda"), probe=probe)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    state = tr.run(state)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in tr.history]
    if not all(h["finite"] for h in tr.history):
        fail(f"nanochat: non-finite loss: {losses}")
    if not all(bool(torch.isfinite(p).all()) for p in adamw.leaves(state.params)):
        fail("nanochat: non-finite parameters after training")
    if not losses[-1] < losses[0]:
        fail(f"nanochat: the loss did not fall: {losses}")
    probed = sum(len(out) for _, out in samples)
    if [s for s, _ in samples] != list(range(0, steps, NANOCHAT_PROBE_EVERY)):
        fail(f"nanochat: the probe sampled at steps {[s for s, _ in samples]}")
    want = {k: v * steps + PROBE_LAUNCHES_PER_SITE[k] * probed
            for k, v in NANOCHAT_LAUNCHES_PER_STEP.items()}
    got = {k: launches[k] for k in want}
    if got != want:
        fail(f"nanochat launches {got}, expected {want} ({steps} steps, "
             f"{probed} probed sites)")
    step_ms = sum(h["dt"] for h in tr.history[1:]) / (steps - 1) * 1e3
    log(f"  [{card}] losses {[round(x, 4) for x in losses]}; {step_ms:.1f} ms/step "
        f"(host clock, steps 2-{steps}, probe calls outside), peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"  launches on the path ({steps} steps + {len(samples)} probe calls over "
        f"{probed} sites): {launches}")

    # the probe against the paper's Table 1, live on the weights trained
    ratios = []
    for s, out in samples:
        me = sum(v["ms_eden_mse_rel"] for v in out.values()) / len(out)
        sr = sum(v["sr_mse_rel"] for v in out.values()) / len(out)
        ratios.append(sr / me)
        log(f"  probe at step {s}: {len(out)} sites, mean relative MSE: MS-EDEN "
            f"{me:.4g} (paper Table 1: {PAPER_TABLE1['ms_eden_mse_rel']:.3g}), SR "
            f"{sr:.4g} (paper: {PAPER_TABLE1['sr_mse_rel']:.3g}), SR / MS-EDEN "
            f"{sr / me:.2f}; forward 4/6 {sum(v['fwd_mse_rel'] for v in out.values()) / len(out):.4g}")
        for site, v in out.items():
            log(f"    {site:16s} ms_eden {v['ms_eden_mse_rel']:.4g}  sr {v['sr_mse_rel']:.4g}"
                f"  fwd {v['fwd_mse_rel']:.4g}  clip(ms_eden) {v['ms_eden_clip_frac']:.4f}"
                f"  outlier mass {v['rht_outlier_mass']:.3g}")
    if min(ratios) < 2.0:
        fail(f"nanochat: SR's relative MSE is not 2x MS-EDEN's at every probe: {ratios}")

    # one site's probe on the card against the same probe on the CPU
    site, pair = probe_site_vs_cpu(torch, state.params, samples[-1][0])
    worst = max(abs(a - b) / (abs(b) + 1e-9) for a, b in pair.values())
    log(f"  probe of {site} card vs CPU, same weights: max relative difference "
        f"{worst:.3g} over {len(pair)} metrics (bar {PROBE_CPU_RTOL:g})")
    if worst > PROBE_CPU_RTOL:
        fail(f"nanochat: the probe's card output disagrees with the CPU: {pair}")

    # Newton-Schulz's share of the step: its f32 GEMMs on every Muon leaf
    mask = muon.partition_mask(state.params)
    mats = [p.detach() for p, use in zip(adamw.leaves(state.params), mask) if use]
    ns_ms, ns_launches = call_device_ms(torch, lambda: [muon.newton_schulz(m) for m in mats],
                                        reps=1)
    prof = profile_train_step(torch, tr, state, step_ms)
    share = (ns_ms / prof["device_ms_per_step"]
             if ns_ms and prof and prof["device_ms_per_step"] else None)
    ns_flops = sum(ns_gemm_flops(m.shape) for m in mats)
    log(f"  Newton-Schulz over the {len(mats)} Muon leaves: {ns_ms:.2f} ms on the device "
        f"({ns_launches:g} launches, {ns_flops / 1e12:.2f} TFLOP of f32 GEMMs: "
        f"{ns_flops / (ns_ms * 1e-3) / 1e12:.1f} TFLOP/s against the {F32_FLOPS / 1e12:g} "
        f"peak); share of the step's device time "
        + ("not measured" if share is None else f"{share:.1%}"))
    out = {"losses": losses, "step_ms": step_ms,
           "step_ms_all": [h["dt"] * 1e3 for h in tr.history],
           "peak_mem_bytes": peak, "launches": launches,
           "probe": [(s, o) for s, o in samples], "sr_over_ms_eden": ratios,
           "probe_cpu_max_rel": worst, "ns_ms": ns_ms, "ns_tflop": ns_flops / 1e12,
           "ns_share": share, "profile": prof, "phase_s": time.perf_counter() - t_phase}
    log(f"  phase 7b took {out['phase_s']:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 8: serving with shared prompts (the prefix cache, its host tier, the
# latency-aware scheduler)
# --------------------------------------------------------------------------

SYSTEM_TOKENS = 384      # 8a/8c: a system prompt of 24 blocks of 16
UNIQUE_TOKENS = 32       # 8a/8c: each request's own tokens after it
# 8b: the reference's Zipf multi-tenant mix (benchmarks/serve_throughput.py
# _zipf_tenant_workload), at this phase's block geometry
ZIPF = {"tenants": 6, "exponent": 1.1, "requests": 12, "prefix": 128,
        "unique": 16, "new": 4}
# 8b/8d: token ids below the reduced vocabulary, so one prompt set serves
# the full-width card run and the reduced CPU run it is held against
SHARED_VOCAB = 512
# 8c's COW case over the bf16 pool, when it is not bitwise: the stream
# equal up to the first token whose cold top-2 logit margin is within this
# many bf16 ulps of the top logit, at least half the tokens compared
# (tests/_torch_streams.py's rule)
BF16_TIE_ULPS = 2
CACHE_STATS = ("lookups", "hits", "hit_tokens", "inserted_blocks",
               "evicted_blocks", "spilled_blocks", "swapped_in_blocks")
ENGINE_STATS = ("prefill_tokens", "prefill_steps", "prefill_skipped_tokens",
                "prefix_hits", "admitted", "finished")


def cuda_sync(torch, dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def host_syncs(torch, fn, dev="cuda"):
    """{source line: count} of the host syncs fn makes (CUDA sync debug
    mode), and fn's result; ({}, fn()) off the card."""
    import warnings
    if dev != "cuda":
        return {}, fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{Path(w.filename).name}:{w.lineno}"
            syncs[key] = syncs.get(key, 0) + 1
    return syncs, out


def fresh_suffixes(torch, g, vocab, n, length):
    """n token lists whose first tokens all differ, so no request matches
    another's block beyond the prompt they share."""
    out, firsts = [], set()
    while len(out) < n:
        s = torch.randint(0, vocab, (length,), generator=g).tolist()
        if s[0] not in firsts:
            firsts.add(s[0])
            out.append(s)
    return out


def quantiles(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2], xs[min(len(xs) - 1, int(len(xs) * 0.99))]


def cache_conserved(eng) -> bool:
    """Every block free or held by the cache alone, once each: free + live
    references == n_blocks, and no slot holds a block."""
    ref = eng.pool._ref
    live = int((ref > 0).sum())
    return (eng.pool.free_block_count + live == eng.pool.n_blocks
            and int(ref.max(initial=0)) <= 1
            and eng.cache.cached_blocks() == live)


def phase_shared_prompt(torch, card, cfg, params, dev="cuda"):
    """8a: eight requests over one 384-token system prompt, cache off (cold)
    and on (hot, primed with the prompt alone), over both pools."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    g = torch.Generator().manual_seed(8)
    system = torch.randint(0, cfg.vocab, (SYSTEM_TOKENS,), generator=g).tolist()
    prompts = [system + s for s in fresh_suffixes(torch, g, cfg.vocab, 8,
                                                  UNIQUE_TOKENS)]
    n, new = len(prompts), 32
    want = {"cold": (n * (SYSTEM_TOKENS + UNIQUE_TOKENS), 0, 0),
            "hot": (SYSTEM_TOKENS + n * UNIQUE_TOKENS, n * SYSTEM_TOKENS, n)}
    out, launches_all = {"prompt_tokens": SYSTEM_TOKENS + UNIQUE_TOKENS}, []
    for kv_quant in (False, True):
        pool_name = "nvfp4_pool" if kv_quant else "bf16_pool"
        attn, other = (("paged_gqa_q", "paged_gqa") if kv_quant
                       else ("paged_gqa", "paged_gqa_q"))
        res = {}
        for mode in ("cold", "hot"):
            if dev == "cuda":
                torch.cuda.reset_peak_memory_stats()
            eng = ServeEngine(cfg, params, EngineConfig(
                n_slots=4, max_len=512, block_size=16, prefill_chunk=16,
                scheme="quartet2", prequant=True, kv_quant=kv_quant,
                prefix_cache=mode == "hot", device=dev))
            ops.reset_launches()
            t0 = time.perf_counter()
            if mode == "hot":
                eng.submit(Request(list(system), 1))  # prime the cache
                eng.run()
            for p in prompts:
                eng.submit(Request(p, new))
            results = [r for r in eng.run() if len(r.prompt) > SYSTEM_TOKENS]
            cuda_sync(torch, dev)
            wall = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            st = eng.stats
            got = (st["prefill_tokens"], st["prefill_skipped_tokens"],
                   st["prefix_hits"])
            if got != want[mode]:
                fail(f"8a {pool_name} {mode}: (prefill tokens, skipped, hits) "
                     f"{got}, want {want[mode]}")
            if len(results) != n or any(len(r.tokens) != new or not all(
                    0 <= t < cfg.vocab for t in r.tokens) for r in results):
                fail(f"8a {pool_name} {mode}: requests not served whole")
            if dev == "cuda" and (launches[attn] <= 0 or launches[other]):
                fail(f"8a {pool_name} {mode}: attention launches {launches}")
            if mode == "cold" and eng.pool.free_block_count != eng.pool.n_blocks:
                fail(f"8a {pool_name} cold: pool blocks leaked")
            if mode == "hot" and not cache_conserved(eng):
                fail(f"8a {pool_name} hot: a block is neither free nor "
                     "cache-owned, or free + live refs != n_blocks")
            ttft = sorted(r.ttft_s for r in results)
            res[mode] = {
                "wall_s": wall, "prefill_tokens": st["prefill_tokens"],
                "prefill_steps": st["prefill_steps"],
                "skipped_tokens": st["prefill_skipped_tokens"],
                "prefix_hits": st["prefix_hits"],
                "ttft_s_median": ttft[len(ttft) // 2], "ttft_s_max": ttft[-1],
                "decode_tok_s": st["decode_tokens"] / st["decode_s"],
                "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                                   if dev == "cuda" else None),
                "cached_blocks": (eng.cache.cached_blocks()
                                  if eng.cache is not None else 0),
                "launches": launches}
            launches_all.append(launches)
            del eng
        c, h = res["cold"], res["hot"]
        peak = [r["peak_mem_bytes"] or 0 for r in (c, h)]
        log(f"  8a [{card}] {pool_name}: prefill {c['prefill_tokens']} -> "
            f"{h['prefill_tokens']} tokens ({h['skipped_tokens']} skipped, "
            f"{h['prefix_hits']} hits; {c['prefill_steps']} -> "
            f"{h['prefill_steps']} prefill forwards); TTFT median "
            f"{c['ttft_s_median'] * 1e3:.1f} -> {h['ttft_s_median'] * 1e3:.1f} ms, "
            f"max {c['ttft_s_max'] * 1e3:.1f} -> {h['ttft_s_max'] * 1e3:.1f} ms; "
            f"decode {c['decode_tok_s']:.1f} / {h['decode_tok_s']:.1f} tok/s; "
            f"peak memory {peak[0] / 2**30:.2f} / {peak[1] / 2**30:.2f} GiB; "
            f"wall {c['wall_s']:.2f} -> {h['wall_s']:.2f} s; "
            f"{h['cached_blocks']} blocks cached at the end")
        out[pool_name] = res
    return out, launches_all


def zipf_prompts(torch):
    """The Zipf tenant mix of 8b: each tenant one shared prefix, tenant
    popularity Zipf(1.1), every request the prefix plus its own tokens."""
    z = ZIPF
    g = torch.Generator().manual_seed(23)
    prefixes = [torch.randint(0, SHARED_VOCAB, (z["prefix"],), generator=g).tolist()
                for _ in range(z["tenants"])]
    w = torch.arange(1, z["tenants"] + 1, dtype=torch.float64) ** -z["exponent"]
    tenants = torch.multinomial(w / w.sum(), z["requests"], replacement=True,
                                generator=g).tolist()
    return [prefixes[t] + torch.randint(0, SHARED_VOCAB, (z["unique"],),
                                        generator=g).tolist()
            for t in tenants], tenants


def zipf_run(torch, cfg, params, dev, spill, prompts, timed=False,
             budget=None):
    """One pass of the Zipf mix through a 24-block pool; returns the engine,
    its results and, when `timed`, the host-tier copies' timings. `budget`
    bounds the host tier's bytes (host_budget_bytes)."""
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    eng = ServeEngine(cfg, params, EngineConfig(
        n_slots=2, max_len=192, block_size=16, n_blocks=24, prefill_chunk=16,
        scheme="quartet2", prequant=True, prefix_cache=True,
        prefix_spill=spill, host_budget_bytes=budget, device=dev))
    rec = host_tier_timers(torch, eng.pool) if timed else None
    for p in prompts:
        eng.submit(Request(p, ZIPF["new"]))
    results = eng.run()
    cuda_sync(torch, dev)
    return eng, results, rec


def host_tier_timers(torch, pool):
    """Wrap the pool's two host-tier copies: host ms of each synchronous
    read (a spill; `fresh` when it had to allocate a pinned buffer, not
    take one from the free list), host ms to dispatch each write (a
    swap-in) and a pair of CUDA events around it (its device time)."""
    rec = {"read_ms": [], "read_fresh": [], "write_dispatch_ms": [],
           "write_events": []}
    read, write = pool.read_block_host, pool.write_block_host

    def timed_read(block):
        allocs = pool.host_allocs
        t0 = time.perf_counter()
        out = read(block)
        rec["read_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["read_fresh"].append(pool.host_allocs > allocs)
        return out

    def timed_write(block, payload):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        write(block, payload)
        b.record()
        rec["write_dispatch_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["write_events"].append((a, b))

    pool.read_block_host, pool.write_block_host = timed_read, timed_write
    return rec


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def phase_zipf_tiers(torch, card, cfg, params, dev="cuda"):
    """8b: the Zipf tenant mix under pool pressure: cache drop, host spill,
    and host spill with the tier bounded at half the unbounded run's
    snapshots (the pinned buffers of dropped snapshots are then reused).
    The cache's and engine's counts equal a reduced CPU run's."""
    prompts, tenants = zipf_prompts(torch)
    refs = cpu_reference("zipf")
    out = {"tenants": ZIPF, "hot_tenant_share": tenants.count(0) / len(tenants)}
    budgets = {}  # spill_budget: snapshots of the spill run // 2, its bytes
    for mode in ("drop", "spill", "spill_budget"):
        spill, b_card = mode != "drop", budgets.get("card")
        t0 = time.perf_counter()
        eng, results, rec = zipf_run(torch, cfg, params, dev, spill, prompts,
                                     timed=dev == "cuda", budget=b_card)
        wall = time.perf_counter() - t0
        card_counts = ({k: eng.cache.stats[k] for k in CACHE_STATS}
                       | {k: eng.stats[k] for k in ENGINE_STATS})
        cpu_counts, cpu_nodes = refs[mode]
        if card_counts != cpu_counts:
            fail(f"8b {mode}: card counts {card_counts} != CPU {cpu_counts}")
        if eng.cache.host_nodes() != cpu_nodes:
            fail(f"8b {mode}: {eng.cache.host_nodes()} host snapshots, the "
                 f"CPU run {cpu_nodes}")
        if len(results) != ZIPF["requests"] or not cache_conserved(eng):
            fail(f"8b {mode}: requests lost or the pool not conserved")
        if spill and not card_counts["swapped_in_blocks"]:
            fail(f"8b {mode}: no block was swapped back in")
        if mode == "spill":
            half = eng.cache.host_nodes() // 2
            budgets = {"blocks": half,
                       "card": half * eng.cache.host_bytes // eng.cache.host_nodes()}
        if mode == "spill_budget" and rec is not None:
            snaps = len(rec["read_ms"])
            if not eng.pool.host_allocs < snaps:
                fail(f"8b {mode}: {eng.pool.host_allocs} pinned buffers "
                     f"allocated for {snaps} snapshots: none was reused")
        p50, p99 = quantiles([r.latency_s for r in results])
        cs = eng.cache.stats
        r = {"wall_s": wall, "counts": card_counts,
             "hit_rate": cs["hits"] / max(cs["lookups"], 1),
             "latency_p50_s": p50, "latency_p99_s": p99,
             "host_bytes": eng.cache.host_bytes,
             "host_nodes": eng.cache.host_nodes(),
             "host_budget_bytes": b_card, "host_budget_blocks": budgets.get(
                 "blocks") if mode == "spill_budget" else None,
             "host_buffers_allocated": eng.pool.host_allocs,
             "host_block_bytes": eng.pool.host_block_bytes}
        if spill and rec is not None:
            reads, fresh = rec["read_ms"], rec["read_fresh"]
            dev_ms = [a.elapsed_time(b) for a, b in rec["write_events"]]
            disp = rec["write_dispatch_ms"]
            r |= {"spill_ms_first": reads[0],
                  "spill_ms_later_median": median(reads[1:]),
                  "spill_ms_fresh_median": median(
                      [t for t, f in zip(reads, fresh) if f]),
                  "spill_ms_reused_median": median(
                      [t for t, f in zip(reads, fresh) if not f]),
                  "spills_timed": len(reads), "spills_fresh": sum(fresh),
                  "swapin_dispatch_ms_median": median(disp),
                  "swapin_device_ms_median": median(dev_ms),
                  "swapins_timed": len(disp)}
        out[mode] = r
        log(f"  8b [{card}] {mode}: hit rate {r['hit_rate']:.3f} "
            f"({cs['hits']}/{cs['lookups']}), skipped "
            f"{eng.stats['prefill_skipped_tokens']} tokens, evicted "
            f"{cs['evicted_blocks']}, spilled {cs['spilled_blocks']}, swapped in "
            f"{cs['swapped_in_blocks']}; latency p50 {p50 * 1e3:.1f} ms, p99 "
            f"{p99 * 1e3:.1f} ms; wall {wall:.2f} s; counts equal the CPU run's")
        if spill and rec is not None:
            budget = ("no budget" if b_card is None else
                      f"budget {b_card} B = {budgets['blocks']} snapshots")
            log(f"     host tier ({budget}): {r['host_bytes']} B in "
                f"{r['host_nodes']} snapshots at the end ({r['host_block_bytes']} "
                f"B a block); {r['host_buffers_allocated']} pinned buffers "
                f"allocated for {len(reads)} spills; spill (device->host, "
                f"synchronous) {r['spill_ms_first']:.3f} ms first, "
                f"{r['spill_ms_later_median']:.3f} ms median of the later "
                f"{len(reads) - 1}; median {r['spill_ms_fresh_median']:.3f} ms "
                f"into a fresh buffer ({r['spills_fresh']}), "
                f"{r['spill_ms_reused_median']:.3f} ms into a reused one "
                f"({len(reads) - r['spills_fresh']}); swap-in dispatch "
                f"{r['swapin_dispatch_ms_median']:.3f} ms, device "
                f"{r['swapin_device_ms_median']:.4f} ms a block (median of "
                f"{len(disp)})")
        del eng
    return out


def recording_engine(eng):
    """Record, per (request, token index), the sampled row's logits as f32
    on the host (single-request runs)."""
    rows, sample = {}, eng._sample

    def rec(last_logits):
        lf = last_logits.float().cpu()
        for i, s in enumerate(eng.slots):
            if s.req is not None:
                rows[(s.req.req_id, len(s.generated))] = lf[i]
        return sample(last_logits)

    eng._sample = rec
    return rows


def kv_at_retirement(torch, eng):
    """Record, per request, a copy of every token leaf of its slot's K/V
    (positions along axis 1) just before the slot is released."""
    from repro_torch.serve.kv_pool import token_leaves
    got, retire = {}, eng._retire_slot

    def rec(i):
        pool, n = eng.pool, eng.pool.length(i)
        blocks = torch.as_tensor(pool._table[i, :pool.blocks_for(n)],
                                 dtype=torch.long, device=eng.device)
        got[eng.slots[i].req.req_id] = [
            leaf[:, blocks].flatten(1, 2)[:, :n].clone()
            for leaf in token_leaves(pool.caches)]
        return retire(i)

    eng._retire_slot = rec
    return got


def bf16_ulp(v: float) -> float:
    import math
    return 2.0 ** (math.floor(math.log2(max(abs(v), 2.0 ** -126))) - 7)


def payload_round_trip(torch, pool, src):
    """read -> write into another block -> read: byte-identical, and a
    PackedKV pool's payload stays uint8."""
    from repro_torch.serve.kv_pool import PackedKV, token_leaves
    p1, n1 = pool.read_block_host(src)
    dst = pool.alloc_cache_block()
    pool.write_block_host(dst, p1)
    p2, n2 = pool.read_block_host(dst)
    pool._decref(dst)
    same = n1 == n2 and torch.equal(p1.buf, p2.buf)
    leaves = [leaf for st in p1.stages for kinds in st.values()
              for pair in kinds.values() for leaf in pair]
    packed = all(isinstance(x, PackedKV) for x in leaves)
    uint8 = all(t.dtype == torch.uint8 for t in token_leaves(p1.stages))
    pool.release_host(p1)
    pool.release_host(p2)
    return same, packed, uint8, n1


def phase_prefix_parity(torch, card, cfg, params, dev="cuda"):
    """8c: scheme bf16 at full width: cold, device-hot and spill-hot streams
    of a block-aligned match bitwise equal over both pools; a match that
    ends inside a block (COW): the matched positions' K/V byte-identical to
    the cold run's, spill-hot bitwise device-hot, and against the cold
    stream bitwise or (bf16 pool) the tie rule; the NVFP4 pool's reported."""
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    from repro_torch.serve.kv_pool import token_leaves
    g = torch.Generator().manual_seed(12)
    system = torch.randint(0, cfg.vocab, (SYSTEM_TOKENS,), generator=g).tolist()
    a, b, c = fresh_suffixes(torch, g, cfg.vocab, 3, UNIQUE_TOKENS)
    warm, probe = system + a, system + b
    fork = system + a[:8] + c[:24]     # diverges 8 tokens into block 24
    matched = SYSTEM_TOKENS + 8        # adopted blocks + the COW'd block's 8
    new = 16
    out = {}

    def engine(**kw):
        return ServeEngine(cfg, params, EngineConfig(
            n_slots=4, max_len=512, block_size=16, prefill_chunk=16,
            scheme="bf16", device=dev, **kw))

    def one(eng, prompt):
        eng.submit(Request(list(prompt), new))
        (r,) = eng.run()
        return r.tokens

    for kv_quant in (False, True):
        pool_name = "nvfp4_pool" if kv_quant else "bf16_pool"
        cold_eng = engine(kv_quant=kv_quant)
        cold_rows, cold_kv = recording_engine(cold_eng), kv_at_retirement(
            torch, cold_eng)
        cold = {"probe": one(cold_eng, probe), "fork": one(cold_eng, fork)}
        hot_eng = engine(kv_quant=kv_quant, prefix_cache=True)
        hot_rows, hot_kv = recording_engine(hot_eng), kv_at_retirement(
            torch, hot_eng)
        one(hot_eng, warm)
        hot = {"probe": one(hot_eng, probe), "fork": one(hot_eng, fork)}
        skipped = hot_eng.stats["prefill_skipped_tokens"]
        spill_eng = engine(kv_quant=kv_quant, prefix_cache=True,
                           prefix_spill=True)
        one(spill_eng, warm)
        evicted = spill_eng.cache.evict(None, 999)
        if spill_eng.cache.cached_blocks() or spill_eng.cache.host_nodes() < 24:
            fail(f"8c {pool_name}: the warm stream did not leave for the host tier")
        node = next(iter(spill_eng.cache.root.children.values()))
        spilled_uint8 = all(t.dtype == torch.uint8
                            for t in token_leaves(node.host.stages))
        spill_kv = kv_at_retirement(torch, spill_eng)
        spill_hot = one(spill_eng, probe)
        swapped = spill_eng.cache.stats["swapped_in_blocks"]
        if hot["probe"] != cold["probe"] or spill_hot != cold["probe"]:
            fail(f"8c {pool_name}: block-aligned streams differ: cold "
                 f"{cold['probe']}, hot {hot['probe']}, spill-hot {spill_hot}")
        if skipped != SYSTEM_TOKENS + SYSTEM_TOKENS + 8 or swapped < 24:
            fail(f"8c {pool_name}: skipped {skipped} (want "
                 f"{2 * SYSTEM_TOKENS + 8}), swapped in {swapped} (want >= 24)")
        if kv_quant and not spilled_uint8:
            fail("8c nvfp4_pool: the spilled payload is not uint8")
        blk = next(iter(spill_eng.cache.root.children.values())).block
        same, packed, uint8, nbytes = payload_round_trip(torch, spill_eng.pool, blk)
        if not same or (kv_quant and not (packed and uint8)):
            fail(f"8c {pool_name}: host round trip not byte-identical "
                 f"(same {same}, packed {packed}, uint8 {uint8})")
        # the COW fork again, from the spill tier: its divergent block is
        # swapped in from the host and copied, the rest computed in the
        # device-hot run's step shapes
        spill_fork = one(spill_eng, fork)
        # COW: the hot run adopts 24 blocks, copies block 24 (8 matched
        # positions) and computes 392..407 as one 16-token chunk and
        # 408..415 as single-token steps; the cold run computes 384..415 in
        # 16-token chunks (GEMMs of M = 4 slots x 16 = 64 rows against
        # M = 4 rows for the single tokens)
        hkv, ckv = hot_kv[2], cold_kv[1]   # the fork: hot's third, cold's second
        prefix_same = all(torch.equal(h[:, :matched], k[:, :matched])
                          for h, k in zip(hkv, ckv))
        if not prefix_same:
            fail(f"8c {pool_name}: the COW stream's K/V of the {matched} "
                 "matched positions differ from the cold run's")
        if spill_fork != hot["fork"] or not all(
                torch.equal(h, k) for h, k in zip(hkv, spill_kv[2])):
            fail(f"8c {pool_name}: the spill-hot COW stream or its K/V differ "
                 f"from the device-hot one's: {spill_fork} against {hot['fork']}")
        rest = [(h[:, matched:len(fork)] != k[:, matched:len(fork)])
                for h, k in zip(hkv, ckv)]
        rest_diff = sum(int(d.sum()) for d in rest) / sum(d.numel() for d in rest)
        cow_bitwise = hot["fork"] == cold["fork"]
        first_diff = next((j for j, (x, y) in enumerate(zip(hot["fork"],
                                                          cold["fork"]))
                           if x != y), None)
        # the logits of every step whose history agrees: up to and
        # including the first differing token
        shared = new if first_diff is None else first_diff + 1
        devs = [float((hot_rows[(2, j)] - cold_rows[(1, j)]).abs().max())
                for j in range(shared)]
        ulps = [bf16_ulp(float(cold_rows[(1, j)].abs().max()))
                for j in range(shared)]
        logit_dev, dev_ulps = max(devs), max(d / u for d, u in zip(devs, ulps))
        margins = [cold_rows[(1, j)].topk(2).values for j in range(new)]
        first_tie = next((j for j, t in enumerate(margins)
                          if float(t[0] - t[1])
                          <= BF16_TIE_ULPS * bf16_ulp(float(t[0]))), None)
        compared = new if first_tie is None else first_tie
        tie_rule_met = cow_bitwise or (first_diff >= compared
                                       and compared >= new // 2)
        if not kv_quant and not tie_rule_met:
            fail(f"8c {pool_name}: COW stream differs at token {first_diff}, "
                 f"first near-tie at {first_tie}: outside the "
                 f"{BF16_TIE_ULPS}-ulp rule (>= {new // 2} tokens compared)")
        out[pool_name] = {
            "block_aligned_bitwise": True, "skipped_tokens": skipped,
            "evicted_blocks": evicted, "swapped_in_blocks": swapped,
            "spilled_payload_uint8": spilled_uint8,
            "round_trip_identical": same, "block_bytes": nbytes,
            "cow_matched_kv_identical": prefix_same,
            "cow_rest_kv_diff_fraction": rest_diff,
            "cow_spill_hot_bitwise_device_hot": True,
            "cow_bitwise": cow_bitwise, "cow_tie_rule_met": tie_rule_met,
            "cow_first_diff": first_diff,
            "cow_first_tie": first_tie, "cow_logit_max_abs_dev": logit_dev,
            "cow_logit_max_dev_ulps": dev_ulps}
        log(f"  8c [{card}] {pool_name}, bf16: cold == device-hot == spill-hot "
            f"bitwise over {new} tokens ({skipped} tokens skipped, {swapped} "
            f"blocks swapped in); host round trip byte-identical ({nbytes} B"
            f"{', packed uint8' if kv_quant else ', bf16'}); COW at token "
            f"{matched}: K/V of the matched positions byte-identical, "
            f"spill-hot == device-hot bitwise (stream and K/V), "
            f"{rest_diff:.2%} of the prompt rest's K/V elements differ (GEMM M = 4 "
            f"single-token rows in the hot run, 64 chunk rows in the cold); "
            f"stream {'bitwise' if cow_bitwise else f'first differing token {first_diff}'}"
            f", first near-tie at {first_tie}; logits max |hot - cold| "
            f"{logit_dev:.4g} ({dev_ulps:.3g} bf16 ulps of the row's largest) "
            f"while the streams agree; the {BF16_TIE_ULPS}-ulp rule "
            + ("met" if tie_rule_met else "not met (not held over the NVFP4 "
               "pool: an ulp of K/V moves codes)"))
        del cold_eng, hot_eng, spill_eng
    return out


class TickClock:
    """A clock that reads the engine's tick count: scheduling by it is the
    same on every device."""

    def __init__(self):
        self.eng = None

    def __call__(self) -> float:
        return float(self.eng.stats["ticks"]) if self.eng is not None else 0.0


def sched_prompts(torch):
    g = torch.Generator().manual_seed(9)
    background = [torch.randint(0, SHARED_VOCAB, (48,), generator=g).tolist()
                  for _ in range(9)]
    critical = [torch.randint(0, SHARED_VOCAB, (32,), generator=g).tolist()
                for _ in range(3)]
    return background, critical


def sched_run(torch, cfg, params, dev, policy, tick_clock):
    """9 background requests (priority 0), then 3 critical ones (priority 2,
    deadline 1 s): returns the admission order, the prefill picks (slot,
    request) and the results."""
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    from repro_torch.serve.scheduler import FifoPolicy, LatencyPolicy
    clock = TickClock() if tick_clock else None
    eng = ServeEngine(cfg, params, EngineConfig(
        n_slots=4, max_len=128, block_size=16, prefill_chunk=16,
        scheme="quartet2", prequant=True, device=dev, clock=clock,
        scheduler=LatencyPolicy(aging_ticks=8) if policy == "latency"
        else FifoPolicy()))
    if clock is not None:
        clock.eng = eng
    admitted, picks = [], []
    try_admit, pick = eng._try_admit, eng.sched.pick_prefill

    def recording_admit(req):
        ok = try_admit(req)
        if ok:
            admitted.append(req.req_id)
        return ok

    def recording_pick(cands, now):
        i = pick(cands, now)
        picks.append((i, eng.slots[i].req.req_id))
        return i

    eng._try_admit, eng.sched.pick_prefill = recording_admit, recording_pick
    background, critical = sched_prompts(torch)
    for p in background:
        eng.submit(Request(p, 8))
    for p in critical:
        eng.submit(Request(p, 8, priority=2, deadline_s=1.0))
    results = eng.run()
    cuda_sync(torch, dev)
    return admitted, picks, results


def phase_scheduler(torch, card, cfg, params, dev="cuda"):
    """8d: LatencyPolicy(aging_ticks=8) against FIFO. By a tick-counting
    clock, the admission order and prefill picks on the card equal the
    reduced CPU run's; by the real clock, latency by class."""
    out = {}
    for policy in ("fifo", "latency"):
        adm, picks, _ = sched_run(torch, cfg, params, dev, policy, True)
        adm_cpu, picks_cpu = cpu_reference("sched")[policy]
        if (adm, picks) != (adm_cpu, picks_cpu):
            fail(f"8d {policy}: card order {adm} / picks {picks} != CPU "
                 f"{adm_cpu} / {picks_cpu}")
        _, _, results = sched_run(torch, cfg, params, dev, policy, False)
        crit = [r for r in results if r.deadline_s is not None]
        bg = [r for r in results if r.deadline_s is None]
        c50, c99 = quantiles([r.latency_s for r in crit])
        b50, b99 = quantiles([r.latency_s for r in bg])
        met = sum(bool(r.deadline_met) for r in crit) / len(crit)
        out[policy] = {"admission_order": adm, "prefill_picks": picks,
                       "critical_p50_s": c50, "critical_p99_s": c99,
                       "background_p50_s": b50, "background_p99_s": b99,
                       "deadlines_met": met}
        log(f"  8d [{card}] {policy}: admission order {adm} (equal to the CPU "
            f"run's, as are the {len(picks)} prefill picks); critical latency "
            f"p50 {c50 * 1e3:.1f} ms p99 {c99 * 1e3:.1f} ms, background p50 "
            f"{b50 * 1e3:.1f} ms p99 {b99 * 1e3:.1f} ms; deadlines met {met:.2f}")
    return out


def phase_deepseek_prefix(torch, card, cfg, params, dev="cuda"):
    """8e: deepseek-v3 (2 layers) with the prefix cache over both latent
    pools: three requests over a 48-token prefix, the first alone, then the
    other two adopt its blocks."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    g = torch.Generator().manual_seed(10)
    prefix = torch.randint(0, cfg.vocab, (48,), generator=g).tolist()
    prompts = [prefix + s for s in fresh_suffixes(torch, g, cfg.vocab, 3, 8)]
    out, launches_all = {}, []
    for kv_quant in (False, True):
        pool_name = "nvfp4_pool" if kv_quant else "bf16_pool"
        attn = "paged_mla_q" if kv_quant else "paged_mla"
        eng = ServeEngine(cfg, params, EngineConfig(
            n_slots=4, max_len=128, block_size=16, prefill_chunk=16,
            scheme="quartet2", prequant=False, kv_quant=kv_quant,
            prefix_cache=True, device=dev))
        finite, sample = [True], eng._sample

        def checked(last_logits, _sample=sample, _finite=finite):
            _finite[0] &= bool(torch.isfinite(last_logits).all())
            return _sample(last_logits)

        eng._sample = checked
        ops.reset_launches()
        t0 = time.perf_counter()
        eng.submit(Request(prompts[0], 8))
        eng.run()
        first = dict(ops.LAUNCHES)
        for p in prompts[1:]:
            eng.submit(Request(p, 8))
        eng.step()
        adopted = sorted(eng.pool._shared_upto)
        eng.run()
        cuda_sync(torch, dev)
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        hot_attn = launches[attn] - first[attn]
        st = eng.stats
        if (st["prefill_skipped_tokens"], st["prefix_hits"]) != (96, 2):
            fail(f"8e {pool_name}: skipped {st['prefill_skipped_tokens']}, "
                 f"hits {st['prefix_hits']} (want 96, 2)")
        if adopted[-2:] != [3, 3] or not finite[0] or (
                dev == "cuda" and hot_attn <= 0):
            fail(f"8e {pool_name}: adopted blocks {adopted}, {attn} launches "
                 f"over them {hot_attn}, logits finite {finite[0]}")
        if not cache_conserved(eng):
            fail(f"8e {pool_name}: the pool is not conserved")
        out[pool_name] = {"wall_s": wall, "skipped_tokens": 96,
                          "attn_launches_over_adopted": hot_attn,
                          "launches": launches}
        launches_all.append(launches)
        log(f"  8e [{card}] deepseek-v3 {pool_name}: 2 x 48 prefix tokens "
            f"skipped, {attn} launched {hot_attn} times over 3 adopted blocks, "
            f"logits finite, pool conserved; wall {wall:.2f} s")
        del eng
    return out, launches_all


def cpu_references(with_mla=True, threads=None):
    """The reduced CPU runs that 8b, 8d, 9e and 12e hold the card against:
    8b's Zipf mix in each mode ((counts, host snapshots); spill_budget
    bounded at half the spill run's snapshots), 8d's admission order and
    prefill picks under each policy, 9e's counts, and 12e's quartet2
    `mla_apply` pass at deepseek-v3's widths. They need nothing of the card,
    so `main` runs them in a process of their own while the card runs the
    earlier phases (`start_cpu_references`)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import lm
    if threads:  # leave the other cores to the card's host work
        torch.set_num_threads(threads)
    small = registry.get("llama_200m").reduced()
    params = lm.init(small, torch.Generator().manual_seed(0), "cpu")
    prompts, _ = zipf_prompts(torch)
    zipf, budget = {}, None
    for mode in ("drop", "spill", "spill_budget"):
        ref, _, _ = zipf_run(torch, small, params, "cpu", mode != "drop", prompts,
                             budget=budget)
        nodes = ref.cache.host_nodes()
        zipf[mode] = ({k: ref.cache.stats[k] for k in CACHE_STATS}
                      | {k: ref.stats[k] for k in ENGINE_STATS}, nodes)
        if mode == "spill":
            budget = nodes // 2 * ref.cache.host_bytes // nodes
    sched = {policy: sched_run(torch, small, params, "cpu", policy, True)[:2]
             for policy in ("fifo", "latency")}
    spec_prefix, _, _ = spec_prefix_run(torch, small, params, "cpu", 1)
    out = {"zipf": zipf, "sched": sched, "spec_prefix": spec_prefix}
    return (out | mla_reference()) if with_mla else out


def mla_reference():
    """12e's CPU pass at deepseek-v3's widths, as {"mla": ...}."""
    import torch
    from repro_torch.configs import registry
    cfg = registry.get("deepseek_v3_671b")
    p, x, _, target, seed = mla_inputs(torch, cfg)
    return {"mla": mla_pass(torch, cfg, p, x, target, seed, "cpu", "quartet2")}


_CPU_REFS = {}


def start_cpu_references():
    """Start `cpu_references` in a process of its own (spawned, so it holds
    no CUDA state) on 4 threads; `cpu_reference` waits for it, and ends the
    process. The counts it gives do not depend on the thread count (the
    card's full-width runs equal the reduced CPU runs'), and the MLA pass is
    held to bars far above an fp32 summation order's effect."""
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(1)
    _CPU_REFS["pool"] = pool
    _CPU_REFS["pending"] = pool.apply_async(cpu_references, (True, 4))


def cpu_reference(key):
    """One of `cpu_references`' results: from the process that
    `start_cpu_references` started, else computed here (the sub-phases' CPU
    rehearsals, or a phase run on its own), the MLA pass only when asked."""
    if "pending" in _CPU_REFS:
        _CPU_REFS["value"] = _CPU_REFS.pop("pending").get()
        _CPU_REFS["pool"].close()
        _CPU_REFS.pop("pool").join()
    value = _CPU_REFS.setdefault("value", {})
    if key not in value:
        value.update(mla_reference() if key == "mla"
                     else cpu_references(with_mla=False))
    return value[key]


# phases 8 and 10: llama-200m's first SHARED_LLAMA_LAYERS of its 10 layers
# (views of phase 4's weights), a depth cut for the smoke's time limit: both
# phases are host-bound (1-2 decode steps a layer-second), and none of their
# checks depends on depth (8b, 8d and 9e hold engine counts, not logits)
SHARED_LLAMA_LAYERS = 5


def llama_cut(params, layers=SHARED_LLAMA_LAYERS):
    """(config, parameters) of llama-200m's first `layers` layers: the
    full model's norms, embedding and head over views of its stacked
    layers (`lm.prefix_stage_params`)."""
    from repro_torch.configs import registry
    from repro_torch.models import lm
    full = registry.get("llama_200m")
    return (dataclasses.replace(full, n_layers=layers),
            {**params, "stages": lm.prefix_stage_params(params, full, layers)})


def phase_prefix(torch, card, llama_params, deepseek_cfg, deepseek_params):
    """Phase 8: serving with shared prompts (8a-8e), llama-200m cut to
    SHARED_LLAMA_LAYERS layers."""
    t0 = time.perf_counter()
    cfg, llama_params = llama_cut(llama_params)
    log("phase 8: serving with shared prompts (prefix cache, host tier, "
        f"latency-aware scheduler; llama-200m at {cfg.n_layers} of 10 layers)")
    out = {}
    out["shared_prompt"], launches_a = phase_shared_prompt(
        torch, card, cfg, llama_params)
    out["zipf_tiers"] = phase_zipf_tiers(torch, card, cfg, llama_params)
    out["parity_bf16"] = phase_prefix_parity(torch, card, cfg, llama_params)
    out["scheduler"] = phase_scheduler(torch, card, cfg, llama_params)
    out["deepseek"], launches_e = phase_deepseek_prefix(
        torch, card, deepseek_cfg, deepseek_params)
    runs = launches_a + launches_e
    out["launches"] = {k: sum(r[k] for r in runs) for k in runs[0]}
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 8 took {out['phase_s']:.1f} s; launches on its main paths: "
        f"{out['launches']}")
    return out


# --------------------------------------------------------------------------
# phase 9: self-speculative decoding, cancel and the token hook
# --------------------------------------------------------------------------

SPEC_K, SPEC_DRAFT = 3, 2     # 9a/9b/9e/9f: llama-200m's first 2 of the 5 served
SPEC_K_WIDE = 4               # 9c: the verify's GEMMs at M = 4 x 5 = 20 (wgmma)
SPEC_DS_DRAFT = 1             # 9d: deepseek-v3's first of 2 layers
SPEC_DS_NEW = 8               # 9d: new tokens a request (16 until phase 16 came)
SPEC_ROUNDS = 4               # rounds in each measured window (8 until phase 17)
SPEC_NEW = 16                 # 9a's two runs: new tokens a request (32 until phase 17)
SPEC_PARTS = ("spec_draft", "spec_catchup", "spec_verify")


def label_spec_parts(eng):
    """Wrap the round's device parts in profiler ranges: the K-step draft,
    the draft's catch-up forwards, and the engine's forward (in a window of
    decode ticks only the verify chunk calls it)."""
    from torch.profiler import record_function

    def wrap(obj, attr, label):
        fn = getattr(obj, attr)

        def run(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        setattr(obj, attr, run)
    wrap(eng.draft, "propose", "spec_draft")
    wrap(eng.draft, "forward", "spec_catchup")
    wrap(eng, "_forward", "spec_verify")


def spec_engine(cfg, params, dev, **kw):
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    return ServeEngine(cfg, params, EngineConfig(**{**dict(
        n_slots=4, max_len=256, block_size=16, prefill_chunk=16,
        scheme="quartet2", prequant=True, spec_k=SPEC_K,
        draft_layers=SPEC_DRAFT, device=dev), **kw}))


def spec_run(torch, cfg, params, prompts, max_new, dev="cuda", **kw):
    """One run of `prompts` through a fresh engine: (engine, {id: tokens},
    wall s); every block of both pools free at the end."""
    from repro_torch.serve.engine import Request
    eng = spec_engine(cfg, params, dev, **kw)
    for p in prompts:
        eng.submit(Request(list(p), max_new))
    t0 = time.perf_counter()
    res = {r.req_id: r.tokens for r in eng.run()}
    cuda_sync(torch, dev)
    wall = time.perf_counter() - t0
    if sorted(res) != list(range(len(prompts))) or any(
            len(t) != max_new or not all(0 <= x < cfg.vocab for x in t)
            for t in res.values()):
        fail("9: a request was not served whole")
    pools = [eng.pool] + ([eng.draft.pool] if eng.draft is not None else [])
    if any(p.free_block_count != p.n_blocks for p in pools):
        fail("9: pool blocks leaked (main or draft pool)")
    return eng, res, wall


def spec_numbers(st, wall):
    """Acceptance (accepted / usable drafts) and tokens a slot emits a
    round (each slot-round emits its accepted drafts plus one)."""
    slot_rounds = st["decode_tokens"] - st["accepted_tokens"]
    return {"acceptance": st["accepted_tokens"] / max(st["draft_tokens"], 1),
            "tokens_per_slot_round": st["decode_tokens"] / max(slot_rounds, 1),
            "rounds": st["spec_rounds"], "draft_tokens": st["draft_tokens"],
            "accepted_tokens": st["accepted_tokens"],
            "decode_tok_s": st["decode_tokens"] / st["decode_s"],
            "round_ms_host": st["decode_s"] / max(st["spec_rounds"], 1) * 1e3,
            "wall_s": wall}


def agreement(a, b):
    """Tokens equal before each row's first difference, over all tokens,
    and the first differing index of each row (None: equal)."""
    same, total, first = 0, 0, {}
    for rid in sorted(a):
        d = next((j for j, (x, y) in enumerate(zip(a[rid], b[rid])) if x != y),
                 None)
        first[rid] = d
        same += len(a[rid]) if d is None else d
        total += len(a[rid])
    return same / total, first


def spec_round_profile(torch, eng, prompts, k, rounds=SPEC_ROUNDS):
    """Rounds at a full batch (4 slots decoding, nothing queued): host ms a
    round (unprofiled); launches a round by kernel and by the regimes of #2
    and #1; host syncs a round by the Python line that caused them (CUDA
    sync debug mode); and from the profiler the device ms a round inside
    each part's range (draft, catch-up, verify), all device ms a round and
    the busy share. The requests are cancelled at the end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import fp4_matmul as FM
    from repro_torch.kernels import nvfp4_quant as NQ
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Request
    ids = [eng.submit(Request(p[:16], 3 * rounds * (k + 1) + 4))
           for p in prompts[:4]]
    while any(s.state != "decode" for s in eng.slots):
        eng.step()

    def window():
        r0 = eng.stats["spec_rounds"]
        for _ in range(rounds):
            eng.step()
        torch.cuda.synchronize()
        return eng.stats["spec_rounds"] - r0

    t0 = time.perf_counter()
    n = window()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    ops.reset_launches()
    FM.REGIME_LAUNCHES.update(gemv=0, mma=0)
    NQ.REGIME_LAUNCHES.update(cluster=0, two_pass=0)
    syncs, n = host_syncs(torch, window)
    launches = {key: v / n for key, v in ops.LAUNCHES.items() if v}
    regimes = {**{f"fp4_matmul.{r}": v / n for r, v in FM.REGIME_LAUNCHES.items()},
               **{f"nvfp4_fos_quant.{r}": v / n
                  for r, v in NQ.REGIME_LAUNCHES.items()}}
    syncs = {key: v / n for key, v in syncs.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        n = window()
    # a range's device-side span (its annotation on the card's timeline)
    # holds the kernels launched inside it; kernels are every other device
    # event
    evs = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    kernels = [(ev.time_range.start, ev.time_range.elapsed_us()) for ev in evs
               if ev.name not in SPEC_PARTS]
    parts = {}
    for lab in SPEC_PARTS:
        spans = [(ev.time_range.start, ev.time_range.end) for ev in evs
                 if ev.name == lab]
        parts[lab] = sum(us for t, us in kernels
                         if any(a <= t < b for a, b in spans)) / 1e3 / n
    dev_us = sum(us for _, us in kernels)
    for rid in ids:
        eng.cancel(rid)
    dev_ms = dev_us / 1e3 / n
    out = {"host_ms_per_round": host_ms,
           "device_ms_per_round": dev_ms if dev_us > 0 else None,
           "busy_share": dev_ms / host_ms if dev_us > 0 else None,
           "part_device_ms": parts, "launches_per_round": launches,
           "regimes_per_round": regimes,
           "syncs_per_round": sum(syncs.values()), "sync_sources": syncs}
    log(f"    {rounds} full-batch rounds: host {host_ms:.2f} ms a round, device "
        + (f"{dev_ms:.3f} ms (busy {dev_ms / host_ms:.1%}); draft "
           f"{parts['spec_draft']:.3f}, catch-up {parts['spec_catchup']:.3f}, "
           f"verify {parts['spec_verify']:.3f} ms a round"
           if dev_us > 0 else "not measured (no device time in the profile)"))
    log(f"    launches a round: {launches}; regimes: {regimes}")
    log(f"    host syncs a round: {out['syncs_per_round']:g} ("
        + ", ".join(f"{key} {v:g}" for key, v in sorted(
            syncs.items(), key=lambda kv: -kv[1])) + ")")
    return out


def llama_prompts(torch, vocab):
    """Phase 4's prompts: 8 of 16-100 tokens from seed 3."""
    g = torch.Generator().manual_seed(3)
    lens = torch.randint(16, 101, (8,), generator=g).tolist()
    return [torch.randint(0, vocab, (n,), generator=g).tolist() for n in lens]


def phase_spec_llama(torch, card, cfg, params, base, dev="cuda"):
    """9a: llama-200m quartet2, phase 4's traffic, spec_k 3 over 2 draft
    layers; two runs bitwise, their streams' agreement with phase 4's (not
    held), the round's profile. 9c: the same at spec_k 4."""
    from repro_torch.kernels import ops
    prompts = llama_prompts(torch, cfg.vocab)
    spec_run(torch, cfg, params, prompts[:2], 4, dev)      # warm-up
    ops.reset_launches()
    eng, a, wall = spec_run(torch, cfg, params, prompts, SPEC_NEW, dev)
    launches = dict(ops.LAUNCHES)
    _, b, _ = spec_run(torch, cfg, params, prompts, SPEC_NEW, dev)
    if a != b:
        fail(f"9a: two spec runs differ: first differing {agreement(a, b)[1]}")
    r = spec_numbers(eng.stats, wall)
    r["launches"] = launches
    if base is not None:
        agree, first = agreement(a, base["streams"])
        r.update(nonspec_decode_tok_s=base["decode_tok_s"],
                 agreement_with_nonspec=agree, first_diff_vs_nonspec=first)
    if dev == "cuda" and any(launches[key] <= 0 for key in SERVING_KERNELS):
        fail(f"9a: a kernel of the path was not launched: {launches}")
    log(f"  9a [{card}] llama-200m quartet2 spec_k {SPEC_K} / {SPEC_DRAFT} draft "
        f"layers: acceptance {r['acceptance']:.4f} ({r['accepted_tokens']} of "
        f"{r['draft_tokens']}), {r['tokens_per_slot_round']:.3f} tokens a slot a "
        f"round, {r['rounds']} rounds; decode {r['decode_tok_s']:.1f} tok/s "
        f"({r['round_ms_host']:.2f} ms a round, host)"
        + (f" against {base['decode_tok_s']:.1f} non-spec (phase 4's traffic, "
           f"the same layers); streams agree with non-spec on "
           f"{r['agreement_with_nonspec']:.1%} of tokens "
           "(quartet2: reported, not held)" if base is not None else "")
        + "; a second run bitwise equal")
    if dev == "cuda":
        label_spec_parts(eng)
        r["profile"] = spec_round_profile(torch, eng, prompts, SPEC_K)
    out = {"spec": r}
    r4 = {}
    if dev == "cuda":
        log(f"  9c [{card}] spec_k {SPEC_K_WIDE}: the verify's GEMMs at M = "
            f"{4 * (SPEC_K_WIDE + 1)}")
        eng4 = spec_engine(cfg, params, dev, spec_k=SPEC_K_WIDE)
        label_spec_parts(eng4)
        r4["profile"] = spec_round_profile(torch, eng4, prompts, SPEC_K_WIDE)
        v3 = r["profile"]["part_device_ms"]["spec_verify"]
        v4 = r4["profile"]["part_device_ms"]["spec_verify"]
        reg = r4["profile"]["regimes_per_round"]
        log(f"  9c verify device ms a round: {v4:.3f} (M = 20, wgmma: "
            f"{reg['fp4_matmul.mma']:g} launches) against 9a's {v3:.3f} (M = 16, "
            f"gemv: {r['profile']['regimes_per_round']['fp4_matmul.gemv']:g})")
    out["spec_k4"] = r4
    return out


def margin_recorder(eng):
    """Record the top-2 logit margin and the top logit of every sampled
    row, per (request, token index): the prefill tick samples its picked
    slot (FIFO: the lowest-index prefilling one), a decode tick every
    decoding slot."""
    margins, phase = {}, [None]
    for name in ("_prefill_tick", "_decode_tick"):
        def tick(_orig=getattr(eng, name), _name=name):
            phase[0] = _name
            return _orig()
        setattr(eng, name, tick)
    sample = eng._sample

    def rec(last_logits):
        top2 = last_logits.float().topk(2, dim=-1).values.cpu()
        if phase[0] == "_prefill_tick":
            rows = [min(i for i, s in enumerate(eng.slots)
                        if s.state == "prefill")]
        else:
            rows = [i for i, s in enumerate(eng.slots) if s.state == "decode"]
        for i in rows:
            s = eng.slots[i]
            margins[(s.req.req_id, len(s.generated))] = (
                float(top2[i, 0] - top2[i, 1]), float(top2[i, 0]))
        return sample(last_logits)

    eng._sample = rec
    return margins


def tie_rule(got, want, margins, max_new):
    """tests/_torch_streams.py's rule: each row equal up to its first token
    whose reference top-2 margin is within BF16_TIE_ULPS bf16 ulps of the top
    logit, at least half of all tokens compared. Returns (equal where
    compared, tokens compared); the rule is met when both hold."""
    compared, equal = 0, True
    for rid in want:
        for j in range(max_new):
            margin, top = margins[(rid, j)]
            if margin <= BF16_TIE_ULPS * bf16_ulp(top):
                break
            equal &= got[rid][j] == want[rid][j]
            compared += 1
    return equal, compared


# 9b: the verify chunk's bf16 logits against single-token steps over the
# same tokens, in bf16 ulps of the row's largest logit (8c's COW stream sits
# 2.5 ulps from cold: another pair of step shapes)
VERIFY_STEP_ULPS = 4


def verify_against_steps(torch, cfg, params, scheme, k=SPEC_K, rounds=4,
                         dev="cuda"):
    """The verify chunk's arithmetic against the non-spec step's, teacher
    forced: 4 rows of a 48-token prompt prefilled alike into two pools,
    then `rounds` times the same K + 1 tokens as K + 1 (4, 1) steps into
    one and as one (4, K + 1) chunk into the other (each pool reads the K/V
    its own steps wrote, as the two engines do). Returns the largest
    |chunk - step| logit in bf16 ulps of its row's largest logit, the
    relative RMS difference, and the share of argmaxes that agree."""
    from repro_torch.serve import decode as serve_decode
    from repro_torch.serve.kv_pool import KVPool
    from repro_torch.serve.prequant import prequantize
    p = prequantize(params, cfg, scheme)
    step = serve_decode.make_paged_serve_step(cfg, scheme)
    g = torch.Generator().manual_seed(19)
    n = 48 + rounds * (k + 1)
    toks = torch.randint(0, cfg.vocab, (4, n), generator=g,
                         dtype=torch.int32).to(dev)
    act = torch.ones(4, dtype=torch.bool, device=dev)
    at = lambda n: torch.full((4,), n, dtype=torch.int32, device=dev)
    pools = []
    for _ in range(2):
        pool = KVPool(cfg, 4, 256, block_size=16, device=dev)
        for s in range(4):
            pool.commit(s, n)
            pool.ensure(s, n)
        for c in range(3):
            step(p, pool.caches, pool.tables_device(),
                 toks[:, 16 * c:16 * (c + 1)], at(16 * c), act)
        pools.append(pool)
    steps = torch.stack([step(p, pools[0].caches, pools[0].tables_device(),
                              toks[:, t:t + 1], at(t), act)[0][:, 0]
                         for t in range(48, n)], 1).float()
    chunk = torch.cat([step(p, pools[1].caches, pools[1].tables_device(),
                            toks[:, t:t + k + 1], at(t), act)[0]
                       for t in range(48, n, k + 1)], 1).float()
    top = steps.abs().amax(-1, keepdim=True).cpu()
    ulp = torch.exp2(torch.floor(torch.log2(top.clamp_min(2.0 ** -126))) - 7)
    d = (chunk - steps).abs().cpu()
    return (float((d / ulp).max()),
            float((d.pow(2).mean() / steps.cpu().pow(2).mean()).sqrt()),
            float((chunk.argmax(-1) == steps.argmax(-1)).double().mean()))


def phase_spec_bf16(torch, card, cfg, params, dev="cuda"):
    """9b: scheme bf16. Held: the verify chunk's logits within
    VERIFY_STEP_ULPS of single-token steps over the same tokens. Reported:
    phase 4's traffic, spec against non-spec by the tie rule with its floor
    (the verify runs n_slots x 4 rows where the step runs n_slots, so the
    streams part where an ulp decides an argmax), and quartet2's
    teacher-forced gap."""
    from repro_torch.serve.engine import Request
    ulps, rel, same = verify_against_steps(torch, cfg, params, "bf16", dev=dev)
    q_ulps, q_rel, q_same = verify_against_steps(torch, cfg, params, "quartet2",
                                                 dev=dev)
    prompts = llama_prompts(torch, cfg.vocab)
    base_eng = spec_engine(cfg, params, dev, scheme="bf16", spec_k=0)
    margins = margin_recorder(base_eng)
    for p in prompts:
        base_eng.submit(Request(p, 32))
    base = {r.req_id: r.tokens for r in base_eng.run()}
    _, spec, _ = spec_run(torch, cfg, params, prompts, 32, dev, scheme="bf16")
    equal, compared = tie_rule(spec, base, margins, 32)
    met = equal and compared >= len(prompts) * 32 // 2
    agree, first = agreement(spec, base)
    log(f"  9b [{card}] bf16 verify chunk against single-token steps, same "
        f"tokens: logits within {ulps:.3g} bf16 ulps of the row's largest "
        f"(bar {VERIFY_STEP_ULPS}), relative RMS {rel:.3g}, argmax agreement "
        f"{same:.1%}; quartet2 (reported): {q_ulps:.3g} ulps, relative RMS "
        f"{q_rel:.3g}, argmax {q_same:.1%}")
    log(f"  9b [{card}] bf16 streams (reported): spec against non-spec "
        f"{'bitwise' if spec == base else 'not bitwise'}, {agree:.1%} of tokens "
        f"before each row's first difference (first differing token by request "
        f"{first}); the {BF16_TIE_ULPS}-ulp tie rule "
        f"{'met' if met else 'not met'} ({compared} of {len(prompts) * 32} "
        f"compared before a near-tie, {'all' if equal else 'not all'} equal)")
    if not ulps <= VERIFY_STEP_ULPS:
        fail(f"9b: the verify chunk's bf16 logits are {ulps} ulps from the "
             f"single-token steps' (bar {VERIFY_STEP_ULPS})")
    return {"verify_vs_steps_ulps": ulps, "verify_vs_steps_rel_rms": rel,
            "verify_vs_steps_argmax": same, "quartet2_verify_vs_steps_ulps": q_ulps,
            "quartet2_verify_vs_steps_rel_rms": q_rel,
            "quartet2_verify_vs_steps_argmax": q_same,
            "bitwise": spec == base, "tie_rule_met": met, "compared": compared,
            "equal_where_compared": equal, "agreement": agree,
            "first_diff": first}


def deepseek_prompts(torch, vocab):
    """Phase 6's prompts: 4 of 16-64 tokens from seed 6."""
    g = torch.Generator().manual_seed(6)
    lens = torch.randint(16, 65, (4,), generator=g).tolist()
    return [torch.randint(0, vocab, (n,), generator=g).tolist() for n in lens]


def phase_spec_deepseek(torch, card, cfg, params, base, dev="cuda"):
    """9d: deepseek-v3 (2 layers), quartet2, bf16 latent pool, phase 6's
    traffic, spec_k 3 over 1 draft layer."""
    from repro_torch.kernels import ops
    prompts = deepseek_prompts(torch, cfg.vocab)
    kw = dict(prequant=False, draft_layers=SPEC_DS_DRAFT)  # packed already
    spec_run(torch, cfg, params, prompts[:1], 2, dev, **kw)   # warm-up
    ops.reset_launches()
    eng, a, wall = spec_run(torch, cfg, params, prompts, SPEC_DS_NEW, dev, **kw)
    launches = dict(ops.LAUNCHES)
    _, b, _ = spec_run(torch, cfg, params, prompts, SPEC_DS_NEW, dev, **kw)
    if a != b:
        fail(f"9d: two spec runs differ: {agreement(a, b)[1]}")
    if dev == "cuda" and (launches["paged_mla"] <= 0 or launches["paged_mla_q"]
                          or launches["paged_gqa"]):
        fail(f"9d: attention launches {launches}")
    r = spec_numbers(eng.stats, wall)
    r["launches"] = launches
    if base is not None:
        agree, first = agreement(a, base["streams"])
        r.update(nonspec_decode_tok_s=base["decode_tok_s"],
                 agreement_with_nonspec=agree, first_diff_vs_nonspec=first)
    log(f"  9d [{card}] deepseek-v3 quartet2 spec_k {SPEC_K} / {SPEC_DS_DRAFT} "
        f"draft layer: acceptance {r['acceptance']:.4f}, "
        f"{r['tokens_per_slot_round']:.3f} tokens a slot a round, decode "
        f"{r['decode_tok_s']:.2f} tok/s ({r['round_ms_host']:.1f} ms a round)"
        + (f" against phase 6's {base['decode_tok_s']:.2f}; streams agree on "
           f"{r['agreement_with_nonspec']:.1%}" if base is not None else "")
        + "; a second run bitwise equal")
    if dev == "cuda":
        label_spec_parts(eng)
        r["profile"] = spec_round_profile(torch, eng, prompts, SPEC_K)
    return r


SPEC_PREFIX_COUNTS = ("prefill_tokens", "prefill_steps", "prefill_skipped_tokens",
                      "prefix_hits", "draft_catchup_tokens",
                      "draft_catchup_steps", "admitted", "finished")


def spec_prefix_run(torch, cfg, params, dev, draft_layers):
    """8a's shared-prompt traffic (ids below SHARED_VOCAB), hot: a
    384-token system prompt primes the cache, then 8 requests of it plus
    32 own tokens, 32 new, through a spec engine with the prefix cache."""
    from repro_torch.serve.engine import Request
    g = torch.Generator().manual_seed(9)
    system = torch.randint(0, SHARED_VOCAB, (SYSTEM_TOKENS,), generator=g).tolist()
    prompts = [system + s for s in fresh_suffixes(torch, g, SHARED_VOCAB, 8,
                                                  UNIQUE_TOKENS)]
    eng = spec_engine(cfg, params, dev, max_len=512, prefix_cache=True,
                      draft_layers=draft_layers)
    eng.submit(Request(list(system), 1))
    eng.run()
    for p in prompts:
        eng.submit(Request(p, 32))
    t0 = time.perf_counter()
    res = eng.run()
    cuda_sync(torch, dev)
    wall = time.perf_counter() - t0
    if len(res) != 8 or any(len(r.tokens) != 32 for r in res):
        fail("9e: requests not served whole")
    if not cache_conserved(eng) or (eng.draft.pool.free_block_count
                                    != eng.draft.pool.n_blocks):
        fail("9e: a block is neither free nor cache-owned, or the draft pool "
             "leaked")
    return {key: eng.stats[key] for key in SPEC_PREFIX_COUNTS}, wall, res


def phase_spec_prefix(torch, card, cfg, params, dev="cuda"):
    """9e: speculation over prefix-cache hits: the draft, whose pool never
    aliases, catches up over every skipped prompt token; the counts equal
    a reduced CPU run's."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    counts, wall, res = spec_prefix_run(torch, cfg, params, dev, SPEC_DRAFT)
    launches = dict(ops.LAUNCHES)
    cpu = cpu_reference("spec_prefix")
    if counts != cpu:
        fail(f"9e: counts {counts} differ from the reduced CPU run's {cpu}")
    want = (8 * SYSTEM_TOKENS, 8 * SYSTEM_TOKENS // 16)
    if (counts["draft_catchup_tokens"], counts["draft_catchup_steps"]) != want:
        fail(f"9e: draft catch-up {counts}, want {want} (tokens, forwards)")
    ttft = sorted(r.ttft_s for r in res)
    log(f"  9e [{card}] spec over prefix hits: {counts['prefill_skipped_tokens']} "
        f"prefill tokens skipped in {counts['prefix_hits']} hits; the draft caught "
        f"up over {counts['draft_catchup_tokens']} tokens in "
        f"{counts['draft_catchup_steps']} forwards; counts equal the reduced CPU "
        f"run's; TTFT median {ttft[len(ttft) // 2] * 1e3:.1f} ms; wall {wall:.2f} s")
    return {"counts": counts, "wall_s": wall, "launches": launches,
            "ttft_s_median": ttft[len(ttft) // 2]}


def phase_spec_cancel(torch, card, cfg, params, dev="cuda"):
    """9f: cancel and the token hook on a spec engine with the prefix cache:
    one request cancelled mid-stream, one while queued; both pools freed;
    the cancelled prompt hits the cache when resubmitted; the hook's tokens
    equal each result's, the result last."""
    from repro_torch.serve.engine import Request
    prompts = llama_prompts(torch, cfg.vocab)[:6]
    calls = []
    # room for every stream in the cache: the cancelled one must survive
    # to the resubmission
    eng = spec_engine(cfg, params, dev, prefix_cache=True, n_blocks=128,
                      token_hook=lambda req, new, res: calls.append(
                          (req.req_id, list(new), res)))
    ids = [eng.submit(Request(p, 32)) for p in prompts]
    while len(eng.slots[0].generated) < 4:
        eng.step()
    cut = list(eng.slots[0].generated)
    fed = eng.pool.length(0)
    queued = ids[5] in [r.req_id for r in eng.queue]
    if not (queued and eng.cancel(ids[0]) and eng.cancel(ids[5])
            and not eng.cancel(ids[0]) and not eng.cancel(10_000)):
        fail("9f: cancel of an in-flight, a queued or an unknown id misbehaved")
    results = eng.run()
    cuda_sync(torch, dev)
    if sorted(r.req_id for r in results) != ids[1:5]:
        fail(f"9f: results {[r.req_id for r in results]}, want {ids[1:5]}")
    if not cache_conserved(eng) or (eng.draft.pool.free_block_count
                                    != eng.draft.pool.n_blocks):
        fail("9f: blocks of a pool leaked after the cancels")
    for r in results:
        mine = [(new, res) for rid, new, res in calls if rid == r.req_id]
        if ([t for new, _ in mine for t in new] != r.tokens or mine[-1][1] is not r
                or any(res is not None for _, res in mine[:-1])):
            fail(f"9f: the hook's tokens for request {r.req_id} differ from "
                 "its result, or the result did not come last")
    hooked = [t for rid, new, _ in calls if rid == ids[0] for t in new]
    if hooked != cut or any(rid == ids[5] for rid, _, _ in calls):
        fail("9f: the hook's tokens of the cancelled requests are wrong")
    before = eng.stats["prefill_skipped_tokens"]
    eng.submit(Request(prompts[0], 2))
    eng.run()
    skipped = eng.stats["prefill_skipped_tokens"] - before
    if skipped != len(prompts[0]) - 1:
        fail(f"9f: the resubmitted prompt skipped {skipped} tokens, want "
             f"{len(prompts[0]) - 1}")
    log(f"  9f [{card}] cancel: one request after {len(cut)} tokens ({fed} "
        f"positions fed) and one queued; both pools freed; the resubmission "
        f"skipped {skipped} prompt tokens; the hook's {len(calls)} calls gave each "
        "result's tokens exactly once, the result last")
    return {"cancelled_after_tokens": len(cut), "fed": fed,
            "resubmit_skipped": skipped, "hook_calls": len(calls)}


def phase_spec_kernels(torch):
    """The kernels at the verify chunk's shapes against their plain
    versions under their bars, and one verify step's calls of each timed:
    #2 at M = 16 (4 slots x 4 rows, the last gemv row count) and M = 20
    (spec_k 4: wgmma) over llama-200m's 70 linears, #5 at Sq = 4 from
    mid-sequence positions over its 10 layers, #7 at Sq = 4 over
    deepseek-v3's 2 layers."""
    from repro_torch.core import formats as F
    from repro_torch.kernels import fp4_matmul as FM
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.serve import kv_pool as KV
    log("phase 9: kernels at the verify chunk's shapes against their plain versions")
    g = torch.Generator(device="cuda").manual_seed(90)
    quant = lambda shape, scale=1.0, dt=torch.float32: ops.nvfp4_fos_quant(
        (torch.randn(shape, generator=g, device="cuda") * scale).to(dt))
    errs = {"fp4_matmul": 0.0, "paged_gqa": 0.0, "paged_mla": 0.0}
    weights = [{name: quant((n, k), k ** -0.5) for name, (n, k) in ARCH_SHAPES.items()}
               for _ in range(10)]
    groups = {}
    for m in (4 * (SPEC_K + 1), 4 * (SPEC_K_WIDE + 1)):
        acts = {k: quant((m, k), dt=torch.bfloat16) for k in (1280, 3456)}
        for name in ("wq", "wi", "w2"):
            w = weights[0][name]
            errs["fp4_matmul"] = max(errs["fp4_matmul"], check_matmul(
                torch, FM, ops, acts[w[0].shape[1] * 2], w))
        calls = [(acts[w[0].shape[1] * 2], w, torch.bfloat16)
                 for lw in weights for w in lw.values()]
        log(f"  fp4_matmul over one verify chunk's 70 GEMMs at M = {m}:")
        groups[f"M{m}"] = matmul_group(torch, FM, ops, calls, 20)
    results = {"fp4_matmul": groups}
    lens = [51, 100, 133, 20]  # mid-sequence: 4 queries from n - 4
    for i in range(2):
        case = attn_case(torch, b=4, sq=4, h=10, kv=10, hd=128, bs=16, maxb=16,
                         lens=lens, seed=91 + i)
        errs["paged_gqa"] = max(errs["paged_gqa"], check_attn(
            torch, PA, ops, case, f"llama-200m verify B4 Sq4 #{i}"))
    layers = [attn_case(torch, b=4, sq=4, h=10, kv=10, hd=128, bs=16, maxb=16,
                        lens=lens, seed=300 + i) for i in range(10)]
    sd = [sdpa_yardstick(torch, *c, KV) for c in layers]
    at_bytes, at_ops = map(sum, zip(*(attn_bytes_ops(*c) for c in layers)))
    fn = lambda: [ops.paged_gqa(*c) for c in layers]
    sdpa_fn = lambda: [f() for f in sd]
    att = {"paged_gqa": dict(
        fn=fn, ms=time_ms(torch, fn, 20),
        plain_ms=time_ms(torch, lambda: [PA.paged_gqa_plain(*c) for c in layers], 3),
        library_ms=time_ms(torch, sdpa_fn, 20),
        library_profiler_ms=device_ms(torch, sdpa_fn, ""),
        bytes=at_bytes, ops=at_ops, peak=F32_FLOPS, calls=len(layers))}
    mla_lens = [44, 61, 76, 29]  # phase 6's prompts mid-decode, 4 queries each
    args = mla_case(torch, F, b=4, sq=4, bs=16, maxb=16, lens=mla_lens,
                    packed=False, seed=92)
    out, again = ops.paged_mla(*args, qk_dim=192), ops.paged_mla(*args, qk_dim=192)
    torch.cuda.synchronize()
    errs["paged_mla"] = check_against_plain(
        torch, "paged_mla", out, PA.paged_mla_plain(*args, 192), (),
        "deepseek-v3 verify B4 Sq4 H128")
    if not torch.equal(out, again):
        fail("paged_mla Sq4: two calls on the same inputs differ")
    att["paged_mla"] = mla_step_group(torch, F, PA, ops, KV, False, mla_lens, 16,
                                      20, seed=500, sq=4)
    log("  one verify chunk's attention calls (llama-200m 10 layers, deepseek-v3 "
        f"{DEEPSEEK_LAYERS}), Sq = 4:")
    finish_results(att, errs)
    results.update(att)
    del weights
    torch.cuda.empty_cache()
    return results, errs


def phase_spec(torch, card, llama_params, ds_cfg, ds_params, deepseek):
    """Phase 9: self-speculative decoding (9a-9f) and its kernels' holds,
    llama-200m cut to SHARED_LLAMA_LAYERS layers (views of phase 4's
    weights, as phases 8 and 10; a depth cut for the time limit). 9a's
    non-speculative baseline is phase 4's prompts on the same cut model,
    SPEC_NEW new tokens a request as 9a's."""
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    t0 = time.perf_counter()
    cfg, llama_params = llama_cut(llama_params)
    log("phase 9: self-speculative decoding, cancel and the token hook "
        f"(llama-200m at {cfg.n_layers} of 10 layers)")
    out = {}
    out["kernels"], errs = phase_spec_kernels(torch)
    prompts = llama_prompts(torch, cfg.vocab)
    eng, results, _, _ = serve_once(torch, cfg, llama_params, EngineConfig,
                                    Request, ServeEngine, prompts, SPEC_NEW)
    base = {"decode_tok_s": eng.stats["decode_tokens"] / eng.stats["decode_s"],
            "streams": {r.req_id: r.tokens for r in results}}
    del eng
    out["llama"] = phase_spec_llama(torch, card, cfg, llama_params, base)
    out["bf16"] = phase_spec_bf16(torch, card, cfg, llama_params)
    out["deepseek"] = phase_spec_deepseek(torch, card, ds_cfg, ds_params,
                                          deepseek["bf16_pool"])
    out["prefix"] = phase_spec_prefix(torch, card, cfg, llama_params)
    out["cancel"] = phase_spec_cancel(torch, card, cfg, llama_params)
    runs = [out["llama"]["spec"], out["deepseek"], out["prefix"]]
    out["launches"] = {k: sum(r["launches"][k] for r in runs)
                       for k in runs[0]["launches"]}
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 9 took {out['phase_s']:.1f} s; launches on its main paths: "
        f"{out['launches']}")
    return out, errs


# --------------------------------------------------------------------------
# phase 10: serving over HTTP (the frontend, its engine thread, obs)
# --------------------------------------------------------------------------

HTTP_WAIT_S = 120.0   # any one await or join of phase 10: a timeout fails it
STEP_WINDOW = 16      # decode steps in a window of 10a's obs on / off costs
HTTP_NEW = 32         # new tokens a request (phase 4's)


async def aw(x):
    import asyncio
    return await asyncio.wait_for(x, HTTP_WAIT_S)


async def http_exchange(port, method, path, obj=None, headers=None):
    """One request: (status, headers, body bytes, ms on the host clock)."""
    import asyncio
    t0 = time.perf_counter()
    reader, writer = await aw(asyncio.open_connection("127.0.0.1", port))
    body = json.dumps(obj).encode() if obj is not None else b""
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: t\r\n{extra}"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await aw(writer.drain())
    status = int((await aw(reader.readline())).split()[1])
    hdrs = {}
    while True:
        h = await aw(reader.readline())
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode().partition(":")
        hdrs[k.strip().lower()] = v.strip()
    payload = await aw(reader.read())
    writer.close()
    if status == 500:
        fail(f"HTTP 500 from {method} {path}: {payload[:200]!r}")
    return status, hdrs, payload, (time.perf_counter() - t0) * 1e3


async def post_json(port, path, obj, headers=None):
    status, hdrs, payload, _ = await http_exchange(port, "POST", path, obj,
                                                   headers)
    return status, json.loads(payload) if payload else None, hdrs


async def sse_client(port, prompt, max_new, kill_after=None, tenant=None):
    """One streamed completion: status, tokens, whether [DONE] came, the
    Retry-After header, and the client-seen TTFT (request sent -> first
    `data:` line, host clock). `kill_after`: reset the socket after that
    many tokens."""
    import asyncio
    t0 = time.perf_counter()
    reader, writer = await aw(asyncio.open_connection("127.0.0.1", port))
    body = json.dumps({"prompt": prompt, "max_tokens": max_new, "stream": True,
                       **({"user": tenant} if tenant else {})}).encode()
    writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await aw(writer.drain())
    status = int((await aw(reader.readline())).split()[1])
    out = {"status": status, "tokens": [], "done": False, "ttft_s": None,
           "retry_after": None}
    while True:
        line = await aw(reader.readline())
        if status != 200:
            if line.lower().startswith(b"retry-after:"):
                out["retry_after"] = float(line.split(b":", 1)[1])
            if not line:
                break
            continue
        if not line:
            break
        if not line.startswith(b"data: "):
            continue
        if out["ttft_s"] is None:
            out["ttft_s"] = time.perf_counter() - t0
        payload = line[6:].strip()
        if payload == b"[DONE]":
            out["done"] = True
            break
        out["tokens"].extend(json.loads(payload)["choices"][0]["tokens"])
        if kill_after is not None and len(out["tokens"]) >= kill_after:
            writer.transport.abort()  # RST: the server sees a dead peer
            return out
    writer.close()
    if status == 500:
        fail("HTTP 500 from a streamed completion")
    return out


class Served:
    """Engine thread + HTTP frontend on 127.0.0.1, an ephemeral port. On exit
    the thread must have stopped and the bridge must hold no error: an
    engine-thread fault (and so any errored handle) fails the phase."""

    def __init__(self, eng, fconf=None, **bridge_kw):
        from repro_torch.serve.frontend import CompletionFrontend, EngineBridge
        self.bridge = EngineBridge(eng, **bridge_kw)
        self.fe = CompletionFrontend(self.bridge, fconf)
        self.steps_on = set()
        step = eng.step

        def recorded():  # the threads that tick the engine
            import threading
            self.steps_on.add(threading.get_ident())
            return step()

        eng.step = recorded

    async def __aenter__(self):
        self.bridge.start()
        self.thread = self.bridge._thread
        await aw(self.fe.start())
        return self

    async def __aexit__(self, *exc):
        await aw(self.fe.stop())
        self.bridge.stop()
        if self.thread.is_alive():
            fail("the engine thread did not stop")
        if self.bridge.error is not None:
            fail(f"the engine thread failed: {self.bridge.error!r}")
        if self.steps_on - {self.thread.ident}:
            fail("the engine was ticked outside the bridge's thread")

    @property
    def port(self):
        return self.fe.port

    async def call(self, fn):
        import asyncio
        return await aw(asyncio.wrap_future(self.bridge.call(fn)))

    async def until(self, pred, what):
        import asyncio
        for _ in range(int(HTTP_WAIT_S / 0.01)):
            if await self.call(pred):
                return
            await asyncio.sleep(0.01)
        fail(f"timed out waiting for {what}")


def run_async(coro):
    import asyncio
    return asyncio.run(asyncio.wait_for(coro, 10 * HTTP_WAIT_S))


def http_engine(cfg, params, dev, **kw):
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    return ServeEngine(cfg, params, EngineConfig(**{**dict(
        n_slots=4, max_len=256, block_size=16, prefill_chunk=16,
        scheme="quartet2", device=dev), **kw}))


def new_obs():
    from repro_torch.obs import Instrumentation, MetricsRegistry
    return Instrumentation(registry=MetricsRegistry())


def direct_run(torch, cfg, params, dev, prompts, max_new, **kw):
    """`engine.run()` over the prompts on the calling thread: (engine,
    results in submission order, wall s)."""
    from repro_torch.serve.engine import Request
    eng = http_engine(cfg, params, dev, **kw)
    ids = [eng.submit(Request(p, max_new)) for p in prompts]
    t0 = time.perf_counter()
    res = {r.req_id: r for r in eng.run()}
    cuda_sync(torch, dev)
    return eng, [res[i] for i in ids], time.perf_counter() - t0


def streamed(torch, eng, prompts, max_new, dev):
    """The prompts as concurrent SSE clients of a frontend over `eng`: the
    client results in prompt order, the wall s, the /metrics scrape (bytes,
    ms; None with obs off) and the launches made while serving. Every
    stream must be whole; afterwards every pool block is free once the
    cache (if any) is emptied."""
    import asyncio
    from repro_torch.kernels import ops

    async def scenario():
        async with Served(eng) as srv:
            ops.reset_launches()
            t0 = time.perf_counter()
            res = await aw(asyncio.gather(
                *[sse_client(srv.port, p, max_new) for p in prompts]))
            wall = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            scrape = None
            if eng.obs.enabled:
                st, _, text, ms = await http_exchange(srv.port, "GET", "/metrics")
                if st != 200 or b"serve_engine_finished_total" not in text:
                    fail(f"/metrics answered {st} without the engine's counters")
                scrape = {"bytes": len(text), "ms": ms}

            def books(e):
                if e.cache is not None:
                    e.cache.evict(None, e.cache.cached_blocks())
                return e.pool.free_block_count, e.pool.n_blocks, e.has_work()
            free, total, busy = await srv.call(books)
            return res, wall, scrape, launches, (free, total, busy)

    res, wall, scrape, launches, (free, total, busy) = run_async(scenario())
    cuda_sync(torch, dev)
    if not all(r["status"] == 200 and r["done"] and len(r["tokens"]) == max_new
               for r in res):
        fail(f"a stream was not served whole: {[(r['status'], r['done'], len(r['tokens'])) for r in res]}")
    if busy or free != total:
        fail(f"after the streams {total - free} pool blocks are held "
             f"(work left: {busy})")
    return res, wall, scrape, launches


def quantiles_s(xs):
    xs = sorted(xs)
    return {"p50": xs[len(xs) // 2], "p99": xs[min(len(xs) - 1,
                                                    int(0.99 * len(xs)))]}


def decode_window_costs(torch, engines, prompts, dev):
    """Obs off against obs on, on direct `engine.step()` calls in the main
    thread at a full batch (4 slots decoding): host ms a decode step over
    three alternating windows each (off, on, off, on, off, on), then on the
    card host syncs a step (CUDA sync debug mode, one window each) and
    device ms a step (torch.profiler, one window each). The requests are
    cancelled at the end."""
    from repro_torch.serve.engine import Request
    for eng in engines.values():
        for p in prompts[:4]:
            eng.submit(Request(p[:16], 5 * STEP_WINDOW + 8))
        while any(s.state != "decode" for s in eng.slots):
            eng.step()

    def window(eng):
        cuda_sync(torch, dev)
        t0 = time.perf_counter()
        for _ in range(STEP_WINDOW):
            eng.step()
        cuda_sync(torch, dev)
        return (time.perf_counter() - t0) / STEP_WINDOW * 1e3

    host = {k: [] for k in engines}
    for _ in range(3):
        for k, eng in engines.items():
            host[k].append(window(eng))
    out = {k: {"host_ms_per_step": sum(v) / len(v), "host_ms_windows": v,
               "syncs_per_step": None, "device_ms_per_step": None}
           for k, v in host.items()}
    if dev == "cuda":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        for k, eng in engines.items():
            syncs, _ = host_syncs(torch, lambda: window(eng))
            out[k]["syncs_per_step"] = sum(syncs.values()) / STEP_WINDOW
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                window(eng)
            us = sum(getattr(ev, "self_device_time_total", 0.0)
                     for ev in prof.key_averages()
                     if ev.device_type == DeviceType.CUDA)
            out[k]["device_ms_per_step"] = us / 1e3 / STEP_WINDOW if us else None
    for eng in engines.values():
        for s in list(eng.slots):
            if s.req is not None:
                eng.cancel(s.req.req_id)
    return out


def phase_http_quartet2(torch, card, cfg, params, prompts, dev="cuda"):
    """10a: quartet2, the bf16 pool, the prefix cache: phase 4's requests as
    concurrent SSE clients against `engine.run()` of the same traffic."""
    log("  10a: quartet2, bf16 pool, prefix cache: "
        f"{len(prompts)} concurrent SSE clients against engine.run()")
    kw = dict(prefix_cache=True)
    run_eng, run_res, run_wall = direct_run(torch, cfg, params, dev, prompts,
                                            HTTP_NEW, **kw)
    on_eng, on_res, _ = direct_run(torch, cfg, params, dev, prompts, HTTP_NEW,
                                   obs=new_obs(), **kw)
    if [r.tokens for r in on_res] != [r.tokens for r in run_res]:
        fail("10a: quartet2 streams with obs on differ from obs off (run())")
    obs = new_obs()
    eng = http_engine(cfg, params, dev, obs=obs, **kw)
    res, wall, scrape, launches = streamed(torch, eng, prompts, HTTP_NEW, dev)
    same = sum(a == b for r, rr in zip(res, run_res)
               for a, b in zip(r["tokens"], rr.tokens))
    agg = obs.trace_sink.aggregates()
    st, rst = eng.stats, run_eng.stats
    n_tok = len(prompts) * HTTP_NEW
    out = {
        "http": {"decode_tok_s": st["decode_tokens"] / st["decode_s"],
                 "tok_s_wall": n_tok / wall, "wall_s": wall,
                 "client_ttft_s": quantiles_s([r["ttft_s"] for r in res]),
                 "trace_ttft_s": {k: agg["ttft_s"][k] for k in ("p50", "p99")},
                 "trace_queue_wait_s": {k: agg["queue_wait_s"][k]
                                        for k in ("p50", "p99")},
                 "trace_decode_tok_s": {k: agg["decode_tok_s"][k]
                                        for k in ("p50", "p99")},
                 "metrics_scrape": scrape, "prefix_hits": st["prefix_hits"]},
        "run": {"decode_tok_s": rst["decode_tokens"] / rst["decode_s"],
                "tok_s_wall": n_tok / run_wall, "wall_s": run_wall,
                "ttft_s": quantiles_s([r.ttft_s for r in run_res])},
        "tokens_equal_to_run": same, "tokens": n_tok, "launches": launches}
    h, r = out["http"], out["run"]
    log(f"    [{card}] HTTP: decode {h['decode_tok_s']:.1f} tok/s in steps, "
        f"{h['tok_s_wall']:.1f} tok/s wall ({wall:.2f} s); run(): "
        f"{r['decode_tok_s']:.1f} tok/s in steps, {r['tok_s_wall']:.1f} tok/s wall "
        f"({run_wall:.2f} s)")
    log(f"    TTFT p50/p99: client-seen {h['client_ttft_s']['p50'] * 1e3:.1f}/"
        f"{h['client_ttft_s']['p99'] * 1e3:.1f} ms, the trace's "
        f"{h['trace_ttft_s']['p50'] * 1e3:.1f}/{h['trace_ttft_s']['p99'] * 1e3:.1f} ms, "
        f"run()'s {r['ttft_s']['p50'] * 1e3:.1f}/{r['ttft_s']['p99'] * 1e3:.1f} ms; "
        f"queue wait p50 {h['trace_queue_wait_s']['p50'] * 1e3:.1f} ms, decode "
        f"p50 {h['trace_decode_tok_s']['p50'] * 1e3:.2f} ms a token")
    log(f"    /metrics scrape {scrape['bytes']} bytes in {scrape['ms']:.2f} ms; "
        f"streams against run(): {same} of {n_tok} tokens equal (reported, not "
        "held: arrival changes batches, and quartet2's absmax couples rows)")
    log(f"    launches while serving: {launches}")
    # obs on against off on direct steps in the main thread
    engines = {"off": http_engine(cfg, params, dev),
               "on": http_engine(cfg, params, dev, obs=new_obs())}
    costs = decode_window_costs(torch, engines, prompts, dev)
    out["step_costs"] = costs
    off, on = costs["off"], costs["on"]
    log(f"    decode step, obs off / on (main thread, {STEP_WINDOW}-step windows): "
        f"host {off['host_ms_per_step']:.3f} / {on['host_ms_per_step']:.3f} ms, "
        + (f"device {off['device_ms_per_step']:.3f} / {on['device_ms_per_step']:.3f} "
           f"ms, host syncs {off['syncs_per_step']:g} / {on['syncs_per_step']:g}"
           if dev == "cuda" and off["device_ms_per_step"] and on["device_ms_per_step"]
           else "device not measured"))
    if dev == "cuda" and off["syncs_per_step"] != on["syncs_per_step"]:
        fail(f"10a: obs changes host syncs a decode step: {off['syncs_per_step']} "
             f"off, {on['syncs_per_step']} on")
    return out


def phase_http_bf16(torch, card, cfg, params, prompts, dev="cuda"):
    """10b: scheme bf16 over both pools: the SSE streams of phase 4's first
    4 requests (one wave of the 4 slots) bitwise the `engine.run()` streams
    of the same prompts, obs on bitwise obs off. Returns its numbers and
    run()'s streams over the bf16 pool."""
    out, ref, prompts = {}, None, prompts[:4]
    for kv_quant in (False, True):
        pool = "NVFP4 pool" if kv_quant else "bf16 pool"
        kw = dict(scheme="bf16", kv_quant=kv_quant)
        _, run_res, _ = direct_run(torch, cfg, params, dev, prompts, HTTP_NEW,
                                   **kw)
        want = [r.tokens for r in run_res]
        ref = ref or want
        _, on_res, _ = direct_run(torch, cfg, params, dev, prompts, HTTP_NEW,
                                  obs=new_obs(), **kw)
        if [r.tokens for r in on_res] != want:
            fail(f"10b: bf16 ({pool}) streams with obs on differ from obs off")
        eng = http_engine(cfg, params, dev, obs=new_obs(), **kw)
        res, wall, _, launches = streamed(torch, eng, prompts, HTTP_NEW, dev)
        got = [r["tokens"] for r in res]
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            fail(f"10b: SSE streams over the {pool} differ from run() "
                 f"(requests {bad})")
        out["nvfp4_pool" if kv_quant else "bf16_pool"] = {
            "wall_s": wall, "launches": launches}
        log(f"  10b [{card}] bf16, {pool}: {len(prompts)} SSE streams bitwise "
            f"run()'s, obs on bitwise off; wall {wall:.2f} s; launches {launches}")
    return out, ref


def phase_http_lifecycles(torch, card, cfg, params, prompts, ref, dev="cuda"):
    """10c: lifecycles under bf16: a client reset mid-stream, queue-full and
    budget 429s, drain under load, the reason-labelled counters, and (on a
    fake clock, the bridge driven in this thread) visibility requeue and
    resume. `ref`: run()'s bf16 streams of `prompts`."""
    import asyncio
    from repro_torch.kernels import ops
    from repro_torch.serve.frontend import (H_REQUEUED, H_RETIRED, EngineBridge,
                                            FrontendConfig, TenantQuota)
    out = {}
    launches = {k: 0 for k in ops.LAUNCHES}

    def count():
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        ops.reset_launches()

    # ---- a client reset mid-stream ---------------------------------------
    obs = new_obs()
    eng = http_engine(cfg, params, dev, scheme="bf16", prefix_cache=True,
                      obs=obs)

    async def disconnect():
        async with Served(eng) as srv:
            ops.reset_launches()
            cut = await sse_client(srv.port, prompts[0], HTTP_NEW, kill_after=2)
            if cut["status"] != 200 or cut["done"] or len(cut["tokens"]) < 2:
                fail(f"10c: the reset stream ran whole: {cut}")
            await srv.until(lambda e: e.stats["cancelled"] == 1,
                            "the disconnect's cancel")
            conserved = await srv.call(lambda e: (
                not e.has_work() and e.pool.free_block_count
                + e.cache.cached_blocks() == e.pool.n_blocks))
            if not conserved:
                fail("10c: the reset request's blocks were not reclaimed")
            before = await srv.call(lambda e: e.stats["prefill_skipped_tokens"])
            again = await sse_client(srv.port, prompts[0], HTTP_NEW)
            count()
            after = await srv.call(lambda e: (e.stats["prefill_skipped_tokens"],
                                              e.stats["prefix_hits"]))
            return cut, again, before, after

    cut, again, before, (skipped, hits) = run_async(disconnect())
    if not again["done"] or len(again["tokens"]) != HTTP_NEW:
        fail("10c: the follow-up stream after the reset was not served whole")
    # reported, not held: the prompt (32 tokens) ends on a block, so the hit
    # stops one token short and recomputes the last prompt position in a
    # (4, 1) step where the cold run computed it inside a 16-token chunk
    agree = next((j for j, (a, b) in enumerate(zip(again["tokens"], ref[0]))
                  if a != b), HTTP_NEW)
    if hits < 1 or skipped - before <= 0:
        fail(f"10c: the follow-up did not hit the cached prefix ({hits} hits)")
    states = [t.state for t in obs.trace_sink.traces]
    n_disc = obs.registry.value("serve_cancellations_total",
                                engine=obs.engine_label, reason="disconnected")
    if "disconnected" not in states or n_disc != 1:
        fail(f"10c: the reset was not recorded as disconnected ({states})")
    out["disconnect"] = {"tokens_before_reset": len(cut["tokens"]),
                         "follow_up_skipped": skipped - before,
                         "follow_up_equal_to_run_for": agree}
    log(f"  10c [{card}] reset after {len(cut['tokens'])} tokens: cancelled "
        f"'disconnected', blocks reclaimed; the follow-up skipped "
        f"{skipped - before} prompt tokens; its first {agree} of {HTTP_NEW} "
        "tokens equal run()'s (reported: its last prompt position runs in "
        "another step shape)")

    # ---- 429s, drain, the reason-labelled counters -----------------------
    obs = new_obs()
    eng = http_engine(cfg, params, dev, scheme="bf16", max_queue=1, obs=obs)
    budget = len(prompts[1]) + HTTP_NEW
    fc = FrontendConfig(tenants={"acme": TenantQuota(token_budget=budget)})
    flood = [prompts[i % len(prompts)] for i in range(12)]

    async def limits():
        async with Served(eng, fc) as srv:
            ops.reset_launches()
            acme = [await post_json(srv.port, "/v1/completions",
                                    {"prompt": prompts[1], "max_tokens": HTTP_NEW},
                                    {"x-tenant": "acme"}) for _ in range(2)]
            res = await aw(asyncio.gather(
                *[sse_client(srv.port, p, HTTP_NEW) for p in flood]))
            b = srv.bridge
            handles = []
            for p in prompts[2:4]:  # one at a time: the queue holds one
                await srv.until(lambda e: not e.queue, "an empty queue")
                handles.append(await aw(asyncio.wrap_future(b.submit(
                    p, HTTP_NEW, track_visibility=False))))
            await srv.until(lambda e: any(h.tokens for h in handles),
                            "tokens of the drained requests")
            drain = await post_json(srv.port, "/admin/drain", {})
            closed = await post_json(srv.port, "/v1/completions",
                                     {"prompt": prompts[0], "max_tokens": 4})
            if not await aw(asyncio.get_running_loop().run_in_executor(
                    None, b.drained.wait, HTTP_WAIT_S)):
                fail("10c: drain never completed")
            count()
            _, _, text, _ = await http_exchange(srv.port, "GET", "/metrics")
            await post_json(srv.port, "/admin/undrain", {})
            return acme, res, handles, drain, closed, text.decode()

    acme, res, handles, drain, closed, text = run_async(limits())
    if [a[0] for a in acme] != [200, 429] or \
            acme[1][1]["error"]["reason"] != "budget_exhausted":
        fail(f"10c: tenant budget: statuses {[a[0] for a in acme]}")
    ok = [r for r in res if r["status"] == 200]
    full = [r for r in res if r["status"] == 429]
    if len(ok) + len(full) != len(res) or not ok or not full:
        fail(f"10c: saturation gave {[r['status'] for r in res]}")
    if not all(r["done"] and len(r["tokens"]) == HTTP_NEW for r in ok):
        fail("10c: an admitted stream under saturation was not served whole")
    if not all(r["retry_after"] and r["retry_after"] > 0 for r in full):
        fail("10c: a 429 came without Retry-After")
    if drain[0] != 202 or closed[0] != 503 or "retry-after" not in closed[2] \
            or closed[1]["error"]["reason"] != "draining":
        fail(f"10c: drain answered {drain[0]}, a new request {closed[0]}")
    if not all(h.state == H_RETIRED for h in handles) or \
            [h.tokens for h in handles] != ref[2:4]:
        fail("10c: the in-flight requests did not finish bitwise under drain")
    lbl = obs.engine_label
    want = {f'serve_rejections_total{{engine="{lbl}",reason="queue_full"}} '
            f'{len(full)}',
            f'serve_frontend_rejections_total{{engine="{lbl}",'
            f'reason="budget_exhausted"}} 1',
            f'serve_frontend_rejections_total{{engine="{lbl}",'
            f'reason="draining"}} 1'}
    if not want <= set(text.splitlines()):
        fail(f"10c: /metrics lacks {want - set(text.splitlines())}")
    out["limits"] = {"served": len(ok), "queue_full_429": len(full),
                     "retry_after_s": sorted(r["retry_after"] for r in full)[0]}
    log(f"  10c [{card}] 12 concurrent clients at max_queue 1: {len(ok)} served "
        f"whole, {len(full)} got 429 with Retry-After (least "
        f"{out['limits']['retry_after_s']:.3f} s); tenant budget 429; drain: the "
        "2 in-flight finished bitwise, a new request 503; /metrics counts every "
        "rejection by reason")

    # ---- visibility requeue and resume (fake clock, this thread) ---------
    # requeued at 8 generated tokens: the resubmitted 40-token prompt hits
    # its 2 cached blocks and feeds the other 8 in (4, 1) steps, the decode
    # step's shape, so the resumed stream is held bitwise (a resubmitted
    # prompt whose uncached rest spans a whole prefill chunk would run it
    # as one, and be held only to ulps)
    class Clock:
        t = 100.0

        def __call__(self):
            return self.t

    clock = Clock()
    eng = http_engine(cfg, params, dev, scheme="bf16", prefix_cache=True,
                      clock=clock, obs=new_obs())
    bridge = EngineBridge(eng, visibility_timeout_s=5.0)
    fut = bridge.submit(prompts[0], HTTP_NEW)
    bridge._drain_commands()
    h = fut.result(timeout=HTTP_WAIT_S)
    while len(h.tokens) < 4:
        eng.step()
    first = h.read_new()[0]
    while len(h.tokens) < 8:
        eng.step()
    clock.t += 60.0
    bridge._check_visibility(clock())
    if h.state != H_REQUEUED or eng.has_work():
        fail("10c: a stalled consumer was not requeued")
    bridge.resume(h)
    bridge._drain_commands()
    skipped = eng.stats["prefill_skipped_tokens"]
    while eng.has_work():
        eng.step()
    cuda_sync(torch, dev)
    count()
    rest = h.read_new()[0]
    if h.state != H_RETIRED or first + rest != ref[0] or h.tokens != ref[0]:
        fail("10c: the resumed stream is not bitwise the uninterrupted one")
    if eng.stats["prefill_skipped_tokens"] <= skipped:
        fail("10c: the resume did not hit the cached prefix")
    out["requeue"] = {"resume_skipped": eng.stats["prefill_skipped_tokens"]
                      - skipped}
    log(f"  10c [{card}] visibility timeout (fake clock): requeued after "
        f"{len(first)} read tokens, resumed over {out['requeue']['resume_skipped']} "
        "cached tokens, the stream bitwise the uninterrupted one")
    out["launches"] = launches
    return out


def thread_kernel_holds(torch, bridge):
    """#1, #2 (gemv at M 4, wgmma at M 64), #5 and #6 at llama-200m's
    shapes, launched on a started bridge's engine thread: bitwise the same
    launches from the main thread, and within each kernel's bar of its
    plain version. Returns {kernel: max |kernel - plain|}."""
    import threading
    from repro_torch.core import formats as F
    from repro_torch.kernels import fp4_matmul as FM
    from repro_torch.kernels import nvfp4_quant as NQ
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA
    g = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn((4, 1280), generator=g, device="cuda").bfloat16()
    n, k = ARCH_SHAPES["wi"]
    mm = {m: (ops.nvfp4_fos_quant(torch.randn((m, k), generator=g, device="cuda")),
              ops.nvfp4_fos_quant(torch.randn((n, k), generator=g, device="cuda")))
          for m in (4, 64)}
    lens = [37, 100, 1, 256]
    attn = attn_case(torch, 4, 1, 10, 10, 128, 16, 16, lens, seed=10)
    attn_q = gqa_q_case(torch, F, 4, 1, 10, 10, 128, 16, 16, lens, seed=10)

    def launch_all():
        o = {"nvfp4_fos_quant": ops.nvfp4_fos_quant(x),
             **{f"fp4_matmul_m{m}": (ops.fp4_matmul(a[0], a[1], b[0], b[1],
                                                    a[2], b[2]),)
                for m, (a, b) in mm.items()},
             "paged_gqa": (ops.paged_gqa(*attn),),
             "paged_gqa_q": (ops.paged_gqa_q(*attn_q),)}
        torch.cuda.synchronize()
        return o

    main = launch_all()
    tid, other = bridge.call(lambda e: (threading.get_ident(),
                                        launch_all())).result(HTTP_WAIT_S)
    if tid != bridge._thread.ident or tid == threading.main_thread().ident:
        fail("the kernel holds did not run on the bridge's thread")
    for key, outs in main.items():
        if not all(torch.equal(a, b) for a, b in zip(outs, other[key])):
            fail(f"{key}: the bridge thread's launch differs from the main "
                 "thread's")
    errs = {}
    pk, sk, gk = other["nvfp4_fos_quant"]
    pr, sr, gr = NQ.nvfp4_fos_quant_plain(x)
    ordk = F.fp4_decode(F.unpack_fp4(pk)).abs()
    ordr = F.fp4_decode(F.unpack_fp4(pr)).abs()
    frac = (F.unpack_fp4(pk) != F.unpack_fp4(pr)).double().mean().item()
    if not (torch.equal(sk, sr) and torch.equal(gk, gr)) or frac >= 1e-4:
        fail(f"nvfp4_fos_quant on the bridge's thread: scales differ or "
             f"{frac} of codes do")
    errs["nvfp4_fos_quant"] = (ordk - ordr).abs().max().item()
    for m, (a, b) in mm.items():
        c = other[f"fp4_matmul_m{m}"][0]
        ref = FM.fp4_matmul_plain(a[0], a[1], b[0], b[1], a[2], b[2])
        err = (c - ref).abs().max().item()
        if not err <= 1e-5 * ref.abs().max().item():
            fail(f"fp4_matmul M {m} on the bridge's thread: {err} off its plain "
                 "version")
        errs["fp4_matmul"] = max(errs.get("fp4_matmul", 0.0), err)
    for key, plain, args in (("paged_gqa", PA.paged_gqa_plain, attn),
                             ("paged_gqa_q", PA.paged_gqa_q_plain, attn_q)):
        o, ref = other[key][0], plain(*args)
        if ((o - ref).abs() > 5e-6 + 1e-5 * ref.abs()).any():
            fail(f"{key} on the bridge's thread: outside 5e-6 + 1e-5 |ref|")
        errs[key] = (o - ref).abs().max().item()
    log("  10: #1, #2 (M 4 gemv, M 64 wgmma), #5 and #6 launched on the bridge's "
        "thread: bitwise the main thread's launches and within their bars of the "
        "plain versions: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return errs


def phase_http(torch, card, llama_params, prompts):
    """Phase 10: serving over HTTP through the frontend and its engine
    thread, with the obs layer (10a-10c), and the kernel holds from the
    bridge's thread; llama-200m cut to SHARED_LLAMA_LAYERS layers."""
    from repro_torch.serve.frontend import EngineBridge
    t0 = time.perf_counter()
    cfg, llama_params = llama_cut(llama_params)
    log("phase 10: serving over HTTP (SSE frontend, engine thread, obs; "
        f"llama-200m at {cfg.n_layers} of 10 layers)")
    bridge = EngineBridge(http_engine(cfg, llama_params, "cuda",
                                      scheme="bf16")).start()
    thread = bridge._thread
    errs = thread_kernel_holds(torch, bridge)
    bridge.stop()
    if bridge.error is not None or thread.is_alive():
        fail("the kernel holds' bridge failed or did not stop")
    out = {"quartet2": phase_http_quartet2(torch, card, cfg, llama_params, prompts)}
    out["bf16"], ref = phase_http_bf16(torch, card, cfg, llama_params, prompts)
    out["lifecycles"] = phase_http_lifecycles(torch, card, cfg, llama_params,
                                              prompts, ref)
    runs = [out["quartet2"], out["bf16"]["bf16_pool"], out["bf16"]["nvfp4_pool"],
            out["lifecycles"]]
    out["launches"] = {k: sum(r["launches"][k] for r in runs)
                       for k in runs[0]["launches"]}
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 10 took {out['phase_s']:.1f} s; launches on its main paths "
        f"(all from the bridge's thread but 10c's resume): {out['launches']}")
    return out, errs


# --------------------------------------------------------------------------
# phase 11: fixed-batch generation (the seed loop) over dense caches
# --------------------------------------------------------------------------

SEED_NEW = 32         # 11a, 11b: new tokens a row (phase 4's)
SEED_DS_NEW = 16      # 11c: (phase 6's)
LONG_PROMPT = 16384   # 11d: one prompt whose prefill takes chunked_sdpa
LONG_NEW = 4
# 11d: layer 0's chunked_sdpa against plain sdpa on the same q, k, v (taken
# in f32): the reference's bar (tests/test_archs.py)
CHUNKED_ATOL = 2e-3
# 11b: prefill + 3 decode steps against the train-mode forward, a fraction of
# max|logit|: the reference's test_decode_matches_full_forward bar
FULL_FORWARD_FRACTION = 0.05
# 11a: #1 and #2 launches of one llama-200m forward on raw weights: 70
# quantized linears, each quantizing its activation and its weight and
# running one GEMM (the bf16 head is not quantized)
SEED_LAUNCHES_PER_FORWARD = {"nvfp4_fos_quant": 140, "fp4_matmul": 70}


def seed_launches(forwards: int) -> dict:
    """#1, #2 and bf16_matmul launches of a greedy_generate run of
    `forwards` forwards (a prefill, then single-token steps): the bf16 head
    runs bf16_matmul once a forward, at any row count."""
    return {**{k: n * forwards for k, n in SEED_LAUNCHES_PER_FORWARD.items()},
            "bf16_matmul": forwards}


def padded_prompts(torch, prompts, dev):
    """(B, S) right-padded int64 tokens and (B,) int32 lengths on dev."""
    lens = [len(p) for p in prompts]
    toks = torch.zeros((len(prompts), max(lens)), dtype=torch.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    return toks.to(dev), torch.tensor(lens, dtype=torch.int32, device=dev)


def recorded_generate(torch, params, cfg, scheme, toks, lens, max_new,
                      dev="cuda"):
    """`greedy_generate` with every step's sampled rows kept: (tokens (B,
    max_new) as lists, {(row, j): (top-2 margin, top logit)}, whether every
    sampled row's logits are finite). Recording adds no launch of the
    port's kernels and no host sync before the loop ends."""
    from repro_torch.serve import decode as D
    rows = []
    make_prefill, make_step = D.make_prefill_step, D.make_serve_step

    def prefill_step(c, s):
        fn = make_prefill(c, s)

        def run(params, cache, batch):
            logits, cache = fn(params, cache, batch)
            rows.append(logits[torch.arange(len(lens), device=lens.device),
                               lens.long() - 1].float())
            return logits, cache
        return run

    def serve_step(c, s):
        fn = make_step(c, s)

        def run(params, cache, tokens, pos):
            logits, cache = fn(params, cache, tokens, pos)
            rows.append(logits[:, -1].float())
            return logits, cache
        return run

    D.make_prefill_step, D.make_serve_step = prefill_step, serve_step
    try:
        out = D.greedy_generate(params, cfg, scheme, toks, max_new,
                                prompt_lens=lens, device=dev)
    finally:
        D.make_prefill_step, D.make_serve_step = make_prefill, make_step
    stack = torch.stack(rows, dim=1)                       # (B, max_new, V)
    top2 = stack.topk(2, dim=-1).values.cpu()
    margins = {(i, j): (float(top2[i, j, 0] - top2[i, j, 1]),
                        float(top2[i, j, 0]))
               for i in range(stack.shape[0]) for j in range(max_new)}
    finite = bool(torch.isfinite(stack).all())
    return {i: r for i, r in enumerate(out.tolist())}, margins, finite


def dense_engine_run(torch, cfg, params, prompts, max_new, dev="cuda", **kw):
    """`prompts` through an engine over dense caches (4 slots, chunk 16):
    ({id: tokens}, every sampled row finite, its margins, the engine)."""
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    eng = ServeEngine(cfg, params, EngineConfig(**{**dict(
        n_slots=4, max_len=256, block_size=16, prefill_chunk=16,
        device=dev), **kw}))
    margins = margin_recorder(eng)
    finite, sample = [True], eng._sample

    def checked(last_logits):
        finite[0] &= bool(torch.isfinite(last_logits).all())
        return sample(last_logits)

    eng._sample = checked
    for p in prompts:
        eng.submit(Request(list(p), max_new))
    res = {r.req_id: r.tokens for r in eng.run()}
    if sorted(res) != list(range(len(prompts))) or any(
            len(t) != max_new or not all(0 <= x < cfg.vocab for x in t)
            for t in res.values()):
        fail("11: a dense engine's request was not served whole")
    return res, finite[0], margins, eng


def phase_generate_llama(torch, card, params, prompts, streams, cfg=None,
                         dev="cuda"):
    """11a (quartet2) and 11b (scheme bf16): `greedy_generate` over phase
    4's first 4 prompts on llama-200m's raw weights, and the engine over
    dense caches. `streams` are phase 4's paged engine's (agreement
    reported). With dev="cpu" and a reduced cfg it rehearses the logic
    (no kernel holds, no device times)."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve import decode as D
    cfg = cfg or registry.get("llama_200m")
    prompts = prompts[:4]
    toks, lens = padded_prompts(torch, prompts, dev)
    b, s = toks.shape
    out = {"prompt_lens": lens.tolist()}
    log("phase 11: fixed-batch generation (greedy_generate) over dense caches")
    log(f"  11a: llama-200m quartet2, raw weights, {b} right-padded prompts of "
        f"{lens.tolist()} tokens, {SEED_NEW} new")
    D.greedy_generate(params, cfg, "quartet2", toks, 2, prompt_lens=lens,
                      device=dev)  # warm-up
    cuda_sync(torch, dev)
    ops.reset_launches()
    first, _, finite = recorded_generate(torch, params, cfg, "quartet2", toks,
                                         lens, SEED_NEW, dev)
    launches = dict(ops.LAUNCHES)
    want = seed_launches(SEED_NEW) if dev == "cuda" else {}
    log(f"  11a launches: {launches} (predicted {want} and no other kernel)")
    if not finite:
        fail("11a: non-finite logits")
    if any(launches[k] != want.get(k, 0) for k in launches):
        fail(f"11a: launches {launches}, predicted {want} and 0 elsewhere")
    t0 = time.perf_counter()
    again = D.greedy_generate(params, cfg, "quartet2", toks, SEED_NEW,
                              prompt_lens=lens, device=dev)
    cuda_sync(torch, dev)
    wall = time.perf_counter() - t0
    if {i: r for i, r in enumerate(again.tolist())} != first:
        fail("11a: a second greedy_generate differs from the first")
    # one decode step of the loop over a prefilled dense cache: host ms (the
    # host clock over 16 steps, synchronized) and device ms (profiler)
    cache = lm.init_cache(cfg, b, s + SEED_NEW + 8, device=dev)
    with torch.no_grad():
        D.make_prefill_step(cfg, "quartet2")(params, cache, {"tokens": toks})
        step = D.make_serve_step(cfg, "quartet2")
        tok = again[:, :1]
        fn = lambda: step(params, cache, tok, lens)
        fn()
        cuda_sync(torch, dev)
        t1 = time.perf_counter()
        for _ in range(16):
            fn()
        cuda_sync(torch, dev)
        host_ms = (time.perf_counter() - t1) / 16 * 1e3
        dev_ms, kernels = (call_device_ms(torch, fn, reps=4) if dev == "cuda"
                           else (None, 0))
    pr = {"tokens_s": b * SEED_NEW / wall, "wall_s": wall, "launches": launches,
          "decode_host_ms": host_ms, "decode_device_ms": dev_ms,
          "decode_kernels": kernels, "streams": first}
    agree, _ = agreement(first, {i: streams[i] for i in first})
    pr["agreement_with_phase4_engine"] = agree
    log(f"  11a [{card}] {b} x {SEED_NEW} tokens in {wall * 1e3:.0f} ms = "
        f"{pr['tokens_s']:.1f} tok/s; a decode step: host {host_ms:.2f} ms, "
        f"device {dev_ms if dev_ms is None else round(dev_ms, 3)} ms "
        f"({kernels:g} kernels); a second run bitwise; {agree:.1%} of tokens as "
        "phase 4's paged engine before each row's first difference (reported)")
    out["quartet2"] = pr
    errs = prefill_kernels(torch, pr, b * s) if dev == "cuda" else {}
    out["bf16"] = generate_bf16(torch, card, cfg, params, prompts, toks, lens,
                                dev)
    return out, errs


def prefill_kernels(torch, pr, m):
    """#1 and #2 at the prefill's M (B x S rows) against their plain
    versions, and one prefill's calls of each timed."""
    from repro_torch.core import formats as F
    from repro_torch.kernels import fp4_matmul as FM
    from repro_torch.kernels import nvfp4_quant as NQ
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(110)
    errs = {"nvfp4_fos_quant": 0.0, "fp4_matmul": 0.0}
    acts = {k: torch.randn((m, k), generator=g, device="cuda").bfloat16()
            for k in (1280, 3456)}
    for x in acts.values():
        errs["nvfp4_fos_quant"] = max(errs["nvfp4_fos_quant"],
                                      check_quant(torch, F, NQ, ops, x))
    qa = {k: ops.nvfp4_fos_quant(x) for k, x in acts.items()}
    for name in ("wq", "wi", "w2"):
        n, k = ARCH_SHAPES[name]
        w = ops.nvfp4_fos_quant(torch.randn((n, k), generator=g, device="cuda")
                                * k ** -0.5)
        errs["fp4_matmul"] = max(errs["fp4_matmul"],
                                 check_matmul(torch, FM, ops, qa[k], w))
    # one prefill's calls timed: 140 quantizations (70 bf16 activations of
    # M rows, 70 f32 weights) and 70 GEMMs at M rows
    quant_calls = ([(m, 1280, "bf16")] * 6 + [(m, 3456, "bf16")]
                   + [(n, k, "f32") for n, k in ARCH_SHAPES.values()]) * 10
    q = quant_group(torch, NQ, ops, quant_calls, g, 5)
    log(f"  nvfp4_fos_quant over one prefill's 140 calls at M = {m}: kernel "
        f"{q['ms']:.4f} ms (profiler {q['profiler_ms']}), plain "
        f"{q['plain_ms']:.3f} ms, bound {q['bound_ms']:.5f} ms ({q['bound_by']})")
    groups = {"nvfp4_fos_quant": q}
    weights = [{nm: ops.nvfp4_fos_quant(torch.randn(
        (n, k), generator=g, device="cuda") * k ** -0.5)
        for nm, (n, k) in ARCH_SHAPES.items()} for _ in range(10)]
    calls = [(qa[w[0].shape[1] * 2], w, torch.bfloat16)
             for lw in weights for w in lw.values()]
    log(f"  fp4_matmul over one prefill's 70 GEMMs at M = {m}:")
    groups["fp4_matmul"] = matmul_group(torch, FM, ops, calls, 5)
    pr["kernel_groups"], pr["prefill_m"] = groups, m
    return errs


def generate_bf16(torch, card, cfg, params, prompts, toks, lens, dev):
    """11b: scheme bf16 (see phase_generate_llama)."""
    from repro_torch.models import lm
    from repro_torch.serve import decode as D
    log("  11b: scheme bf16, llama-200m: prefill + decode against the train "
        "forward, ragged rows against rows alone, the dense engine against "
        "the paged engine and against greedy_generate")
    g2 = torch.Generator(device=dev).manual_seed(111)
    ids = torch.randint(0, cfg.vocab, (2, 19), generator=g2, device=dev)
    with torch.no_grad():
        full, _ = lm.forward(params, cfg, {"tokens": ids}, "bf16", D.SEED,
                             mode="train")
        full = full.float()
        bar = FULL_FORWARD_FRACTION * float(full.abs().max())
        cache = lm.init_cache(cfg, 2, 24, device=dev)
        pf, cache = lm.forward(params, cfg, {"tokens": ids[:, :16]}, "bf16",
                               D.SEED, caches=cache, mode="prefill")
        errs_ff = [float((pf.float() - full[:, :16]).abs().max())]
        for t in range(3):
            dl, cache = lm.forward(params, cfg, {"tokens": ids[:, 16 + t:17 + t]},
                                   "bf16", D.SEED, caches=cache, mode="decode",
                                   pos=16 + t)
            errs_ff.append(float((dl[:, 0].float() - full[:, 16 + t]).abs().max()))
    log(f"  11b prefill + 3 decode steps against the train forward: max|dlogit| "
        f"{max(errs_ff):.4g} (bar {bar:.4g} = {FULL_FORWARD_FRACTION} max|logit|)")
    if not max(errs_ff) < bar:
        fail(f"11b: prefill + decode {errs_ff} off the train forward (bar {bar})")
    batch, b_margins, finite = recorded_generate(torch, params, cfg, "bf16",
                                                 toks, lens, SEED_NEW, dev)
    solo = {}
    for i, p in enumerate(prompts):
        one = D.greedy_generate(params, cfg, "bf16", toks[i:i + 1, :len(p)],
                                SEED_NEW, device=dev)
        solo[i] = one[0].tolist()
    dense, d_finite, _, _ = dense_engine_run(torch, cfg, params, prompts,
                                             SEED_NEW, dev, scheme="bf16",
                                             paged=False)
    paged, p_finite, p_margins, _ = dense_engine_run(torch, cfg, params,
                                                     prompts, SEED_NEW, dev,
                                                     scheme="bf16")
    if not (finite and d_finite and p_finite):
        fail("11b: non-finite logits")
    holds = {}
    for name, got, ref, mg in (("ragged_vs_alone", solo, batch, b_margins),
                               ("dense_vs_paged_engine", dense, paged, p_margins),
                               ("dense_engine_vs_greedy", dense, batch, b_margins)):
        equal, compared = tie_rule(got, ref, mg, SEED_NEW)
        agree, first_diff = agreement(got, ref)
        holds[name] = {"bitwise": got == ref, "equal_where_compared": equal,
                       "compared": compared, "agreement": agree,
                       "first_diff": first_diff}
        log(f"  11b [{card}] {name}: {'bitwise' if got == ref else 'not bitwise'}, "
            f"{compared} of {len(prompts) * SEED_NEW} tokens compared before a "
            f"{BF16_TIE_ULPS}-ulp near-tie, {'all' if equal else 'NOT all'} equal; "
            f"first differences {first_diff}")
        # Held: every token before its row's first near-tie equal, and at
        # least one compared a row on average. Not held: the half-compared
        # floor of tests/_torch_streams.py, which random full-width weights
        # miss (a top-2 gap under 2 ulps of a logit near 4 comes about one
        # token in seven: 19 of 128 compared in the first call, all equal).
        # The CPU rehearsal's bf16 GEMMs vary with M: held on the card only.
        if dev == "cuda" and (not equal or compared < len(prompts)):
            fail(f"11b: {name} breaks the {BF16_TIE_ULPS}-ulp tie rule")
    return {"full_forward_err": max(errs_ff), "full_forward_bar": bar, **holds}


def phase_generate_deepseek(torch, card, cfg, params, paged_streams,
                            dev="cuda"):
    """11c: deepseek-v3 (2 layers), quartet2, phase 6's packed weights and
    prompts: the prefill through the expanded-form MLA, decode over the
    dense latent caches; a dense engine's streams. `paged_streams` are
    phase 6's bf16-pool engine's (agreement reported)."""
    from repro_torch.kernels import ops
    prompts = deepseek_prompts(torch, cfg.vocab)
    toks, lens = padded_prompts(torch, prompts, dev)
    log(f"  11c: deepseek-v3 ({cfg.n_layers} layers) quartet2, packed weights, "
        f"prompts of {lens.tolist()} tokens, {SEED_DS_NEW} new")
    ops.reset_launches()
    gen, _, finite = recorded_generate(torch, params, cfg, "quartet2", toks,
                                       lens, SEED_DS_NEW, dev)
    launches = dict(ops.LAUNCHES)
    if not finite or not all(0 <= t < cfg.vocab for r in gen.values() for t in r):
        fail("11c: non-finite logits or tokens outside the vocabulary")
    attn = ("paged_gqa", "paged_gqa_q", "paged_mla", "paged_mla_q")
    if any(launches[k] for k in attn) or (dev == "cuda" and not all(
            launches[k] > 0 for k in SEED_LAUNCHES_PER_FORWARD)):
        fail(f"11c: launches {launches}: want #1 and #2, no attention kernel")
    engine, e_finite, _, _ = dense_engine_run(
        torch, cfg, params, prompts, SEED_DS_NEW, dev, paged=False,
        prequant=False)
    if not e_finite:
        fail("11c: the dense engine's logits are not finite")
    a_gen, _ = agreement(gen, paged_streams)
    a_eng, first = agreement(engine, paged_streams)
    log(f"  11c [{card}] launches {launches}; finite; tokens as phase 6's paged "
        f"engine before each row's first difference (reported): greedy_generate "
        f"{a_gen:.1%}, the dense engine {a_eng:.1%} (first differences {first})")
    return {"launches": launches, "agreement_greedy_vs_paged": a_gen,
            "agreement_dense_engine_vs_paged": a_eng, "streams": gen}


def phase_generate_long(torch, card, params, cfg=None, dev="cuda",
                        n_tokens=LONG_PROMPT):
    """11d: one LONG_PROMPT-token prompt, llama-200m quartet2: the prefill
    takes chunked_sdpa in every layer. Layer 0's q, k, v held: chunked_sdpa
    within CHUNKED_ATOL of plain sdpa (both on the f32 values), #1 and #2 at
    M = LONG_PROMPT against their plain versions; chunked_sdpa, plain sdpa
    and F.scaled_dot_product_attention timed, the run's peak memory."""
    from repro_torch.configs import registry
    from repro_torch.core import formats as F
    from repro_torch.kernels import fp4_matmul as FM
    from repro_torch.kernels import nvfp4_quant as NQ
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    from repro_torch.serve import decode as D
    cfg = cfg or registry.get("llama_200m")
    g = torch.Generator(device=dev).manual_seed(112)
    toks = torch.randint(0, cfg.vocab, (1, n_tokens), generator=g, device=dev)
    log(f"  11d: one {n_tokens}-token prompt, llama-200m quartet2, "
        f"{LONG_NEW} new tokens (prefill through chunked_sdpa)")
    first, calls = [], [0]
    chunked = A.chunked_sdpa

    def recording(q, k, v, **kw):
        if not first:
            first.append((q, k, v))
        calls[0] += 1
        return chunked(q, k, v, **kw)

    if dev == "cuda":
        # engines with recording hooks (closures on the engine) are freed by
        # the cycle collector only: without it their weights, deepseek-v3's
        # 21 GB among them, would count in this run's peak
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    A.chunked_sdpa = recording
    try:
        t0 = time.perf_counter()
        gen = D.greedy_generate(params, cfg, "quartet2", toks, LONG_NEW,
                                device=dev)
        cuda_sync(torch, dev)
        wall = time.perf_counter() - t0
    finally:
        A.chunked_sdpa = chunked
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else None
    want = seed_launches(LONG_NEW) if dev == "cuda" else {}
    if calls[0] != cfg.n_layers or any(
            launches[k] != want.get(k, 0) for k in launches):
        fail(f"11d: chunked_sdpa ran {calls[0]} times (want {cfg.n_layers}), "
             f"launches {launches} (want {want})")
    if not all(0 <= t < cfg.vocab for t in gen[0].tolist()):
        fail("11d: tokens outside the vocabulary")
    (q, k, v), = first
    qf, kf, vf = q.float(), k.float(), v.float()
    err = float((chunked(qf, kf, vf) - A.sdpa(qf, kf, vf)).abs().max())
    log(f"  11d layer 0 chunked_sdpa against plain sdpa (f32 q, k, v of "
        f"{tuple(q.shape)}): max|do| {err:.3g} (bar {CHUNKED_ATOL})")
    if not err <= CHUNKED_ATOL:
        fail(f"11d: chunked_sdpa {err} off plain sdpa (bar {CHUNKED_ATOL})")
    out = {"wall_s": wall, "peak_mem_bytes": peak, "launches": launches,
           "chunked_vs_sdpa": err}
    if dev != "cuda":
        return out, {}
    sdpa_lib = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    times = {"chunked_sdpa_ms": time_ms(torch, lambda: chunked(q, k, v), 3, 1),
             "sdpa_ms": time_ms(torch, lambda: A.sdpa(q, k, v), 2, 1),
             "torch_sdpa_ms": time_ms(torch, lambda: sdpa_lib(qt, kt, vt,
                                                              is_causal=True), 5)}
    del qf, kf, vf, first, q, k, v, qt, kt, vt
    errs = {"nvfp4_fos_quant": 0.0, "fp4_matmul": 0.0}
    acts = {kk: torch.randn((LONG_PROMPT, kk), generator=g,
                            device="cuda").bfloat16() for kk in (1280, 3456)}
    for x in acts.values():
        errs["nvfp4_fos_quant"] = max(errs["nvfp4_fos_quant"],
                                      check_quant(torch, F, NQ, ops, x))
    for name in ("wq", "wi", "w2"):
        n, kk = ARCH_SHAPES[name]
        w = ops.nvfp4_fos_quant(torch.randn((n, kk), generator=g, device="cuda")
                                * kk ** -0.5)
        errs["fp4_matmul"] = max(errs["fp4_matmul"], check_matmul(
            torch, FM, ops, ops.nvfp4_fos_quant(acts[kk]), w))
    del acts
    torch.cuda.empty_cache()
    out.update(times)
    log(f"  11d [{card}] {n_tokens} + {LONG_NEW} tokens in {wall:.2f} s, "
        f"peak memory {peak / 2**30:.2f} GiB; layer 0 attention: chunked_sdpa "
        f"{times['chunked_sdpa_ms']:.2f} ms, plain sdpa {times['sdpa_ms']:.2f} ms, "
        f"F.scaled_dot_product_attention {times['torch_sdpa_ms']:.3f} ms (a "
        "yardstick only)")
    return out, errs


# --------------------------------------------------------------------------
# phase 12: the rest of the transformer registry; MoE and MLA training
# --------------------------------------------------------------------------

# 12a: the registry's other transformers, each served at its published widths
REGISTRY_ARCHS = ("granite_8b", "chatglm3_6b", "nemotron_4_15b",
                  "llava_next_mistral_7b", "deepseek_moe_16b")
# 12a depth cuts, for the smoke's time limit only (widths are never cut):
# every config serves 4 layers. At full depth (36, 28, 32 and 32 layers; 8
# of deepseek-moe-16b's 28) 12a took about 160 s on an H100 host, and the
# whole smoke ran past its 1,200 s on a host whose host-bound phases ran
# about a third slower; deepseek-moe-16b's 28 layers fit (10.2 GiB
# resident) but serve at 291 ms of host a decode step with 16 s of TTFT.
# At 8 layers 12a took 94 s on a host whose phases 8-12 ran 1.4-1.6x slower
# than other H100 hosts, where the whole smoke with phase 13 took 1,316 s
REGISTRY_LAYERS = dict.fromkeys(("granite_8b", "chatglm3_6b", "nemotron_4_15b",
                                 "llava_next_mistral_7b", "deepseek_moe_16b"), 4)
REGISTRY_NEW = 8            # new tokens a request (4 requests of 16-64 tokens)
REGISTRY_PROFILE_STEPS = 4  # full-batch decode steps timed, then profiled (13a)
REGISTRY_12A_PROFILE_STEPS = 1  # 12a's
PACK_CHUNK = 4              # matrices `init_packed` holds in f32 at once
# 12b: (H, KV, layers of one decode step) of the registry's GQA group sizes
GROUP_SIZES = {
    "granite-8b H32 KV8": (32, 8, 36),      # H/KV 4, also llava
    "nemotron-4-15b H48 KV8": (48, 8, 32),  # H/KV 6
    "chatglm3-6b H32 KV2": (32, 2, 28),     # H/KV 16
    "deepseek-moe-16b H16 KV16": (16, 16, 28),  # H/KV 1
}
LLAVA_PREFILL = (2, 64)     # 12c: rows x stub-embed positions
LLAVA_DECODE = 4            # 12c: decode steps after the prefill
# 12d: deepseek-moe-16b at its published widths, depth cut to 2 layers
# (about 9 GB of f32 state a layer: parameters, gradients, two moments)
MOE_TRAIN_LAYERS = 2
# 2 steps (4 until phase 17 came): the second is the steady step timed
MOE_TRAIN_ARGS = ["--arch", "deepseek_moe_16b", "--scheme", "quartet2",
                  "--steps", "2", "--seq", "256", "--batch", "4", "--lr", "2e-3",
                  "--log-every", "1"]
# 12e: one mla_apply forward + backward at deepseek-v3's widths, card against
# CPU with injected tensor draws (the backward is seeded by half the mean
# square distance of the output to a fixed target). The output within
# MLA_TRAIN_REL_RMS relative RMS: only fp32 summation orders differ there.
# Each gradient by the quartet2 noise rule: its card-CPU relative RMS
# distance below Q2_NOISE_FRACTION of the quantization noise itself (the
# CPU's quartet2 gradient against its bf16 one). The quantizers turn small
# differences of their inputs into whole codes, so the gradients differ
# more than the output does; the witness is the card against itself with
# every element of x moved one bf16 ulp. On the H100 the card sits at
# 0.013-0.18 of the noise a leaf and the witness at 0.41-0.76; the bar lies
# between them: the card must differ from the CPU less than a one-ulp move
# of the input makes the CPU differ from itself. The backward GEMM over
# wkv_a's padded contraction (576 -> 640) on the card against its plain
# composition on the same operands, within quartet2_backward_gemm's bar
# (1e-3 max|C|).
MLA_TRAIN_TOKENS = (2, 64)
MLA_TRAIN_REL_RMS = 1e-2
Q2_NOISE_FRACTION = 0.3
BWD_GEMM_RTOL = 1e-3


def packed_bytes(tree) -> int:
    """Bytes of the PackedQWeight leaves of a parameter tree."""
    from repro_torch.core.linear import PackedQWeight
    if isinstance(tree, dict):
        return sum(packed_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(packed_bytes(v) for v in tree)
    if isinstance(tree, PackedQWeight):
        return sum(t.numel() * t.element_size() for t in tree)
    return 0


class KernelShapes:
    """The shapes at which the main path calls #1 (x's shape and dtype), #2
    ((M, N, K)) and the backward GEMM (each operand's shape and
    `ms_eden_requant.layout`) on the card, recorded while a run is inside
    `with shapes:` by wrapping the wrappers in `kernels.ops` (the wrapped
    calls launch and count as before). 12f holds each kernel against its
    plain version at every shape recorded."""

    def __init__(self):
        self.quant, self.matmul, self.bwd = set(), set(), set()

    def __enter__(self):
        from repro_torch.kernels import ms_eden_requant as MR
        from repro_torch.kernels import ops
        self._real = quant, matmul, bwd = (
            ops.nvfp4_fos_quant, ops.fp4_matmul, ops.quartet2_backward_gemm)

        def rec_quant(x):
            if x.is_cuda:
                self.quant.add((tuple(x.shape), x.dtype))
            return quant(x)

        def rec_matmul(a, sa, b, *rest, **kw):
            if a.is_cuda:
                self.matmul.add((a.shape[0], b.shape[0], a.shape[1] * 2))
            return matmul(a, sa, b, *rest, **kw)

        def rec_bwd(a, b, *rest):
            if a.is_cuda:
                self.bwd.add((tuple(a.shape), MR.layout(a), tuple(b.shape),
                              MR.layout(b)))
            return bwd(a, b, *rest)

        ops.nvfp4_fos_quant, ops.fp4_matmul = rec_quant, rec_matmul
        ops.quartet2_backward_gemm = rec_bwd
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        (ops.nvfp4_fos_quant, ops.fp4_matmul,
         ops.quartet2_backward_gemm) = self._real


def laid_out(torch, g, shape, layout):
    """A random f32 (M, K) tensor on the card laid out as `layout` says
    (`ms_eden_requant.layout`): rows at pitch ld, or the transpose of a
    row-major (K, ld) tensor."""
    (m, k), (kind, ld) = shape, layout
    if kind == "rows":
        return torch.randn((m, ld), generator=g, device="cuda")[:, :k]
    return torch.randn((k, ld), generator=g, device="cuda")[:, :m].T


def phase_registry_kernels(torch, shapes, label="12f", runs="12a, 12c and 12d"):
    """12f: #1, #2 and #3/#4 against their plain versions at every shape the
    main paths of 12a, 12c and 12d gave them (`KernelShapes`): #1 by
    `check_quant` on each input shape and dtype; #2 by `check_matmul` on
    each (M, N, K), 4/6-quantized operands; each backward GEMM's operands
    as the backward laid them out, phase 1 bitwise (`check_phase1`), phase
    2 over both in one launch bitwise (`check_phase2_pair`), and the GEMM
    against its plain composition (`check_backward_gemm`). Returns the
    largest error of each kernel."""
    from repro_torch.core import formats as F
    from repro_torch.core import rht as R
    from repro_torch.core import rng
    from repro_torch.kernels import fp4_matmul as FM
    from repro_torch.kernels import ms_eden_requant as MR
    from repro_torch.kernels import nvfp4_quant as NQ
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    log(f"phase {label}: #1 at {len(shapes.quant)} input shapes, #2 at "
        f"{len(shapes.matmul)} (M, N, K), #3/#4 and the backward GEMM at "
        f"{len(shapes.bwd)} operand pairs, as {runs} gave them")
    g = torch.Generator(device="cuda").manual_seed(1206)
    draws = rng.HashDraws([12, 6])
    errs = {"nvfp4_fos_quant": 0.0, "fp4_matmul": 0.0, "ms_eden_phase1": 0.0,
            "ms_eden_phase2": 0.0}
    for shape, dtype in sorted(shapes.quant, key=str):
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        errs["nvfp4_fos_quant"] = max(errs["nvfp4_fos_quant"],
                                      check_quant(torch, F, NQ, ops, x))
    regimes = {}
    for n, k in sorted({(n, k) for _, n, k in shapes.matmul}):
        w = ops.nvfp4_fos_quant(torch.randn((n, k), generator=g, device="cuda")
                                * k ** -0.5)
        for m in sorted(m for m, n2, k2 in shapes.matmul if (n2, k2) == (n, k)):
            x = ops.nvfp4_fos_quant(torch.randn((m, k), generator=g,
                                                device="cuda").bfloat16())
            errs["fp4_matmul"] = max(errs["fp4_matmul"],
                                     check_matmul(torch, FM, ops, x, w))
            regime = FM.plan(m, n, k).regime
            regimes[regime] = regimes.get(regime, 0) + 1
        del w
    for i, (sa, la, sb, lb) in enumerate(sorted(shapes.bwd, key=str)):
        a, b = laid_out(torch, g, sa, la), laid_out(torch, g, sb, lb)
        signs = draws.signs(i, R.block_size(sa[1]), "cuda")
        pa, pb = (check_phase1(torch, MR, ops, x, signs) for x in (a, b))
        check_phase2_pair(torch, MR, ops, pa, pb, draws, 2 * i + 100)
        errs["fp4_matmul"] = max(errs["fp4_matmul"],
                                 check_backward_gemm(torch, draws, a, b))
        del a, b, pa, pb
    torch.cuda.empty_cache()
    log(f"  {label}: every shape held (#2 regimes {regimes}); largest errors "
        f"{errs}; {time.perf_counter() - t0:.1f} s")
    return errs


def serve_registry_arch(torch, card, cfg, params, prompts, kv_quant, dev="cuda",
                        profile_steps=REGISTRY_PROFILE_STEPS):
    """One 12a (or 13a) run: 4 requests through ServeEngine over packed
    weights; in-vocabulary tokens, every block free, #1, #2 and the pool's
    GQA kernel launched (rwkv6 has no attention layer) and no other
    attention kernel; its numbers, host syncs of one full-batch decode step
    and a decode profile. dev="cpu" with a reduced config rehearses its
    logic on the CPU (no syncs, profile or memory)."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    kw = dict(kv_quant=kv_quant, prequant=False, device=dev)  # packed as drawn
    serve_once(torch, cfg, params, EngineConfig, Request, ServeEngine,
               prompts[:1], 2, **kw)  # warm-up, not measured
    cuda = dev == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    eng, results, setup_s, wall = serve_once(
        torch, cfg, params, EngineConfig, Request, ServeEngine, prompts,
        REGISTRY_NEW, **kw)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    attn = None if cfg.rwkv else ("paged_gqa_q" if kv_quant else "paged_gqa")
    served(torch, cfg, eng, results, prompts, REGISTRY_NEW, launches,
           tuple(k for k in ("nvfp4_fos_quant", "fp4_matmul", attn) if k)
           if cuda else ())
    others = {k for k in ("paged_gqa", "paged_gqa_q", "paged_mla", "paged_mla_q")
              if k != attn and launches[k]}
    if others:
        fail(f"{cfg.name}: another attention kernel launched: {launches}")
    r = serving_numbers(results, eng.stats, setup_s, wall, peak, launches)
    r["streams"] = {res.req_id: res.tokens for res in results}
    fill_decode(eng, Request, prompts, 6)
    r["syncs_per_decode_step"], _ = host_syncs(torch, eng.step, dev)
    eng.run()
    pool = "NVFP4 pool" if kv_quant else "bf16 pool"
    log(f"  [{card}] {cfg.name} ({cfg.n_layers} layers, {pool}): 4 requests x "
        f"{REGISTRY_NEW} tokens: decode {r['decode_tok_s']:.2f} tok/s "
        f"({r['decode_step_ms']:.1f} ms/step host), TTFT median "
        f"{r['ttft_s_median']:.2f} s, peak memory {peak / 2**30:.2f} GiB, wall "
        f"{wall:.1f} s; host syncs a decode step "
        f"{sum(r['syncs_per_decode_step'].values())} "
        f"({', '.join(f'{k} {v}' for k, v in sorted(r['syncs_per_decode_step'].items()))})")
    log(f"  launches on the main path: {launches}")
    r["profile"] = (profile_decode(torch, eng, Request, prompts,
                                   profile_steps) if cuda else None)
    return r


def phase_llava_prefill(torch, card, cfg, params, dev="cuda"):
    """12c: llava's prefill from stub embeds into dense caches
    (`make_prefill_step`), then LLAVA_DECODE decode steps from tokens
    (`make_serve_step`): finite, a second run bitwise; #1 / #2 launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.decode import make_prefill_step, make_serve_step

    b, s = LLAVA_PREFILL
    g = torch.Generator(device=dev).manual_seed(13)
    emb = torch.randn((b, s, cfg.d_model), generator=g,
                      device=dev).bfloat16() * 0.3
    prefill = make_prefill_step(cfg, "quartet2")
    step = make_serve_step(cfg, "quartet2")

    def run():
        ops.reset_launches()
        cache = lm.init_cache(cfg, b, s + LLAVA_DECODE + 4, device=dev)
        logits, cache = prefill(params, cache, {"embeds": emb})
        counts = [dict(ops.LAUNCHES)]
        outs = [logits]
        for i in range(LLAVA_DECODE):
            toks = outs[-1][:, -1].argmax(-1, keepdim=True)
            lg, cache = step(params, cache, toks,
                             torch.full((b,), s + i, dtype=torch.int32,
                                        device=dev))
            outs.append(lg)
        cuda_sync(torch, dev)
        counts.append(dict(ops.LAUNCHES))
        return outs, counts

    t0 = time.perf_counter()
    first, counts = run()
    wall = time.perf_counter() - t0
    second, counts2 = run()
    if not all(bool(torch.isfinite(x).all()) for x in first):
        fail("12c: llava prefill from embeds gave non-finite logits")
    if tuple(first[0].shape) != (b, s, cfg.vocab):
        fail(f"12c: prefill logits of shape {tuple(first[0].shape)}")
    if not all(torch.equal(x, y) for x, y in zip(first, second)) or counts != counts2:
        fail("12c: a second prefill + decode run is not bitwise the first")
    pf = {k: counts[0][k] for k in ("nvfp4_fos_quant", "fp4_matmul")}
    total = {k: counts[1][k] for k in ("nvfp4_fos_quant", "fp4_matmul")}
    log(f"  [{card}] 12c llava prefill from embeds ({b} x {s}) + {LLAVA_DECODE} "
        f"decode steps from tokens: finite, second run bitwise; #1 / #2 launches "
        f"prefill {pf['nvfp4_fos_quant']} / {pf['fp4_matmul']}, in all "
        f"{total['nvfp4_fos_quant']} / {total['fp4_matmul']}; wall {wall:.2f} s")
    return {"prefill_launches": pf, "launches": counts[1], "wall_s": wall}


def phase_registry_serving(torch, card, shapes, dev="cuda"):
    """12a (and 12c on llava's weights): each config of REGISTRY_ARCHS at its
    published widths, weights packed as drawn, served over the bf16 pool;
    chatglm3-6b also over the NVFP4 pool; the kernel shapes of every run
    recorded into `shapes`. dev="cpu" rehearses it on the reduced
    configs."""
    from repro_torch.configs import registry
    from repro_torch.serve.prequant import init_packed

    cuda = dev == "cuda"
    mem = (lambda: torch.cuda.memory_allocated()) if cuda else (lambda: 0)
    out = {}
    for i, arch in enumerate(REGISTRY_ARCHS):
        cfg = registry.get(arch) if cuda else registry.get(arch).reduced()
        if cuda and arch in REGISTRY_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=REGISTRY_LAYERS[arch])
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        base = mem()
        t0 = time.perf_counter()
        params = init_packed(cfg, torch.Generator(device=dev).manual_seed(120 + i),
                             "quartet2", dev, chunk=PACK_CHUNK)
        cuda_sync(torch, dev)
        a = {"layers": cfg.n_layers, "init_s": time.perf_counter() - t0,
             "init_peak_bytes": (torch.cuda.max_memory_allocated() if cuda else 0)
             - base, "weight_bytes": mem() - base,
             "packed_bytes": packed_bytes(params)}
        log(f"phase 12a: {cfg.name} at its published widths, {cfg.n_layers} layers: "
            f"drawn and packed in {a['init_s']:.1f} s, {a['weight_bytes'] / 2**30:.2f} "
            f"GiB resident ({a['packed_bytes'] / 2**30:.2f} GiB packed), init peak "
            f"{a['init_peak_bytes'] / 2**30:.2f} GiB")
        g = torch.Generator().manual_seed(120 + i)
        lens = torch.randint(16, 65, (4,), generator=g).tolist()
        prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
                   for n in lens]
        a["prompt_lens"] = lens
        with shapes:
            a["bf16_pool"] = serve_registry_arch(
                torch, card, cfg, params, prompts, False, dev,
                REGISTRY_12A_PROFILE_STEPS)
            if arch == "chatglm3_6b":
                a["nvfp4_pool"] = serve_registry_arch(
                    torch, card, cfg, params, prompts, True, dev,
                    REGISTRY_12A_PROFILE_STEPS)
            if cfg.input_mode == "embeds":
                out["llava_prefill"] = phase_llava_prefill(torch, card, cfg,
                                                           params, dev)
        a["seconds"] = time.perf_counter() - t0
        log(f"  {cfg.name} took {a['seconds']:.1f} s")
        out[arch] = a
        del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def phase_group_kernels(torch):
    """12b: #5 and #6 at the registry's group sizes (hd 128, Sq 1 and 16,
    both pools) against their plain versions under the attention bar, two
    calls bitwise equal; one decode step's calls of each config timed (4
    rows mid-decode, one call a layer), with the bound and SDPA."""
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.serve import kv_pool as KV

    log("phase 12b: paged_gqa / paged_gqa_q at the registry's group sizes")
    errs = {"paged_gqa": 0.0, "paged_gqa_q": 0.0}
    groups = {"paged_gqa": {}, "paged_gqa_q": {}}
    for i, (label, (h, kv, layers)) in enumerate(GROUP_SIZES.items()):
        for sq, lens, dead in ((1, [47, 100, 131, 18], (3,)),
                               (16, [16, 64, 100, 33], ())):
            for packed in (False, True):
                name = "paged_gqa_q" if packed else "paged_gqa"
                kern = ops.paged_gqa_q if packed else ops.paged_gqa
                plain = PA.paged_gqa_q_plain if packed else PA.paged_gqa_plain
                # the bf16 pool at unit scale, as phase 3's bf16 cases
                args = (gqa_q_case(torch, F, b=4, sq=sq, h=h, kv=kv, hd=128, bs=16,
                                   maxb=16, lens=lens, dead=dead, seed=1200 + i)
                        if packed else
                        attn_case(torch, b=4, sq=sq, h=h, kv=kv, hd=128, bs=16,
                                  maxb=16, lens=lens, seed=1200 + i))
                out, again = kern(*args), kern(*args)
                torch.cuda.synchronize()
                errs[name] = max(errs[name], check_against_plain(
                    torch, name, out, plain(*args), dead if packed else (),
                    f"{label} Sq{sq} (H/KV {h // kv})"))
                if not torch.equal(out, again):
                    fail(f"{name} {label} Sq{sq}: two calls on the same inputs differ")
        lens = [40, 57, 72, 25]  # 12a's prompts mid-decode
        for packed in (False, True):
            name = "paged_gqa_q" if packed else "paged_gqa"
            calls, sd, nbytes, ops_n = [], [], 0, 0
            for layer in range(layers):
                if packed:
                    c = gqa_q_case(torch, F, b=4, sq=1, h=h, kv=kv, hd=128, bs=16,
                                   maxb=16, lens=lens, seed=1300 + layer)
                    q, kc, ks, vc, vs, table, pos = c
                    sd.append(gather_sdpa(torch, q, KV.gather_view(KV.PackedKV(kc, ks), table),
                                          KV.gather_view(KV.PackedKV(vc, vs), table), pos))
                    keys, pairs = keys_and_pairs(pos.tolist(), 1)
                    nbytes += (q.numel() * 2 + keys * kv * 256 * 0.5625
                               + table.numel() * 4 + pos.numel() * 4 + q.numel() * 4)
                    ops_n += pairs * h * (2 * 128 + 2 * 128)
                else:
                    c = attn_case(torch, b=4, sq=1, h=h, kv=kv, hd=128, bs=16,
                                  maxb=16, lens=lens, seed=1300 + layer)
                    sd.append(sdpa_yardstick(torch, *c, KV))
                    nb, no = attn_bytes_ops(*c)
                    nbytes, ops_n = nbytes + nb, ops_n + no
                calls.append(c)
            kern = ops.paged_gqa_q if packed else ops.paged_gqa
            plain = PA.paged_gqa_q_plain if packed else PA.paged_gqa_plain
            fn = lambda calls=calls, kern=kern: [kern(*c) for c in calls]
            sdpa_fn = lambda sd=sd: [f() for f in sd]
            grp = dict(fn=fn, ms=time_ms(torch, fn, 20),
                       plain_ms=time_ms(torch, lambda: [plain(*c) for c in calls], 3),
                       library_ms=time_ms(torch, sdpa_fn, 20),
                       library_profiler_ms=device_ms(torch, sdpa_fn, ""),
                       bytes=nbytes, ops=ops_n, peak=F32_FLOPS, calls=layers)
            p = PA.plan(4, 1, h, kv, 16, 16, 128)
            log(f"  {name} {label}, one decode step ({layers} layers): plan "
                f"{p.splits} splits, {p.grid} CTAs, row groups {p.row_groups}")
            finish_results({name: grp}, errs)
            groups[name][label] = grp
            del calls, sd
        torch.cuda.empty_cache()
    return groups, errs


def phase_moe_train(torch, card, shapes, dev="cuda"):
    """12d: deepseek-moe-16b at its published widths, MOE_TRAIN_LAYERS layers,
    through `repro_torch.launch.train`'s code path (the registry's config
    cut here, as phase 6 cuts deepseek-v3's), its kernel shapes recorded
    into `shapes`; then the same recipe under bf16 (no kernel of the port
    runs), whose losses say whether quartet2's are the recipe's; and a
    reduced deepseek-moe-16b quartet2 train step, card against CPU
    (`phase_train_reference`). dev="cpu" rehearses the first two at the
    reduced size (seq 32)."""
    from repro_torch.configs import registry
    from repro_torch.core import rng
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import lm
    from repro_torch.models.blocks import chunked_head_ce
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import step_seed

    cuda = dev == "cuda"
    args = MOE_TRAIN_ARGS if cuda else [*MOE_TRAIN_ARGS, "--device", "cpu",
                                        "--reduced", "--seq", "32"]
    steps = int(args[args.index("--steps") + 1])
    real_get, real_uniform = registry.get, rng.HashDraws.uniform
    cut = dataclasses.replace(real_get("deepseek_moe_16b"), n_layers=MOE_TRAIN_LAYERS)
    cfg = cut if cuda else cut.reduced()
    log(f"phase 12d: training deepseek-moe-16b at its published widths, "
        f"{cfg.n_layers} layers (quartet2, AdamW, batch 4 x seq 256, {steps} steps)")
    drawn = []

    def counted_uniform(self, tag, shape, device):
        drawn.append(tuple(shape))
        return real_uniform(self, tag, shape, device)

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    registry.get = lambda name: cut if registry._norm(name) == "deepseek_moe_16b" \
        else real_get(name)
    rng.HashDraws.uniform = counted_uniform
    ops.reset_launches()
    try:
        with shapes:
            out, trainer, state = launch_train.run(args)
            cuda_sync(torch, dev)
    finally:
        registry.get, rng.HashDraws.uniform = real_get, real_uniform
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    losses = out["losses"]
    if out["arch"] != cfg.name or len(losses) != steps:
        fail(f"12d: trained {out['arch']} for {len(losses)} steps")
    if not all(h["finite"] for h in trainer.history):
        fail(f"12d: non-finite training loss: {losses}")
    if not all(bool(torch.isfinite(p).all()) for p in adamw.leaves(state.params)):
        fail("12d: non-finite parameters after training")
    path = ("nvfp4_fos_quant", "fp4_matmul", "ms_eden_phase1", "ms_eden_phase2")
    if cuda and any(launches[k] <= 0 for k in path):
        fail(f"12d: a kernel of the training path was not launched: {launches}")
    if drawn:
        fail(f"12d: {len(drawn)} SR uniform tensors drawn, e.g. {drawn[:3]}")
    batch = {k: v.to(dev) for k, v in trainer.corpus.batch_at(state.step).items()}
    seed = step_seed(0, state.step)
    with torch.no_grad():  # the loss, and its CE and aux read on their own
        loss = lm.lm_loss(state.params, cfg, batch, "quartet2", seed)
        hidden, _, aux = lm._forward(
            state.params, state.params["stages"], lm.layer_specs(cfg), cfg,
            batch, "quartet2", seed, caches=None, mode="train", pos=None,
            active=None, block_table=None, head=False)
        ce = chunked_head_ce(hidden, lm.head_weight(state.params, cfg),
                             batch["labels"], cfg.quantize_lm_head, "quartet2",
                             seed)
    if not (float(aux) > 0 and torch.equal(loss, ce + 0.01 * aux)):
        fail(f"12d: loss {float(loss)} is not ce {float(ce)} + 0.01 x aux "
             f"{float(aux)}")
    syncs, _ = host_syncs(torch, lambda: trainer.train_step(state, batch), dev)
    log(f"  [{card}] losses {[round(x, 4) for x in losses]}; {out['step_ms']:.1f} "
        f"ms/step (host clock, steps 2-{steps}), peak memory {peak / 2**30:.2f} GiB; "
        f"loss - ce = {float(loss - ce):.6g}, 0.01 x aux = {0.01 * float(aux):.6g}")
    log(f"  launches on the training path: {launches}; SR uniform tensors drawn: 0; "
        f"host syncs a step {sum(syncs.values())} "
        f"({', '.join(f'{k} {v}' for k, v in sorted(syncs.items()))})")
    prof = profile_train_step(torch, trainer, state, out["step_ms"]) if cuda else None
    res = {"layers": cfg.n_layers, "losses": losses, "step_ms": out["step_ms"],
           "tokens_per_s": out["tokens_per_s"], "peak_mem_bytes": peak,
           "launches": launches, "aux": float(aux), "ce": float(ce),
           "syncs_per_step": syncs, "profile": prof}
    del trainer, state, batch, hidden
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # the recipe under bf16: the same weights, batches and steps
    bf16_args = list(args)
    bf16_args[bf16_args.index("--scheme") + 1] = "bf16"
    registry.get = lambda name: cut if registry._norm(name) == "deepseek_moe_16b" \
        else real_get(name)
    try:
        bf16, trainer, state = launch_train.run(bf16_args)
    finally:
        registry.get = real_get
    res["bf16_losses"] = bf16["losses"]
    log(f"  the same recipe under bf16: losses "
        f"{[round(x, 4) for x in bf16['losses']]} (quartet2 "
        f"{[round(x, 4) for x in losses]})")
    del trainer, state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        res["reduced_vs_cpu"] = phase_train_reference(torch, "deepseek_moe_16b")
    return res


class TensorDraws:
    """Draws as the reference's tests inject them: RHT signs and SR uniforms
    as tensors, here from a CPU generator seeded by (site seed, tag), so the
    CPU and the card get the same numbers (12e)."""

    def __init__(self, seed):
        import numpy as np
        a, b = (int(v) for v in np.asarray(seed, np.uint32))
        self.key = (a << 32) | b

    def _gen(self, tag):
        import torch
        return torch.Generator().manual_seed((self.key * 131 + tag) % 2**63)

    def signs(self, tag, n, device):
        import torch
        bits = torch.randint(0, 2, (n,), generator=self._gen(tag))
        return (bits * 2 - 1).float().to(device)

    def uniform(self, tag, shape, device):
        import torch
        return torch.rand(tuple(shape), generator=self._gen(tag)).to(device)


def mla_inputs(torch, cfg):
    """12e's inputs, drawn on the CPU from seed 14: one MLA layer's weights,
    x (2 x 64 tokens, bf16), x moved one bf16 ulp away from 0, the target
    of the loss that seeds the backward, and the site seed."""
    import numpy as np
    from repro_torch.models import mla
    from repro_torch.models.blocks import weight_drawer
    b, s = MLA_TRAIN_TOKENS
    g = torch.Generator().manual_seed(14)
    p = {k: v[0] for k, v in mla.mla_init(weight_drawer(g, "cpu"), 1, cfg,
                                          "cpu").items()}
    x = torch.randn((b, s, cfg.d_model), generator=g).bfloat16()
    x_ulp = (x.view(torch.int16) + 1).view(torch.bfloat16)
    target = torch.randn((b, s, cfg.d_model), generator=g)
    return p, x, x_ulp, target, np.array([12, 5], np.uint32)


def mla_pass(torch, cfg, p, xin, target, seed, d, scheme):
    """One `mla_apply` forward + backward on device d under `scheme`, with
    TensorDraws injected (`core.rng.draws` patched): (loss, output, the
    gradients of x and of each weight, launches), all on the CPU."""
    from repro_torch.core import rng
    from repro_torch.kernels import ops
    from repro_torch.models import mla
    real_draws = rng.draws
    rng.draws = lambda sd: sd if hasattr(sd, "signs") else TensorDraws(sd)
    ops.reset_launches()
    try:
        pp = {k: v.to(d).requires_grad_(True) for k, v in p.items()}
        xx = xin.to(d).requires_grad_(True)
        out, _ = mla.mla_apply(pp, xx, cfg, scheme, seed, 0)
        loss = 0.5 * (out.float() - target.to(d)).pow(2).mean()
        grads = torch.autograd.grad(loss, [xx, *pp.values()])
        cuda_sync(torch, d)
    finally:
        rng.draws = real_draws
    return (float(loss.detach()), out.detach().float().cpu(),
            [gr.float().cpu() for gr in grads], dict(ops.LAUNCHES))


def phase_mla_backward(torch, card, dev="cuda"):
    """12e: one `mla_apply` forward + backward at deepseek-v3's published
    widths (H 128, q_lora 1536, kv_lora 512 + rope 64) over 2 x 64 tokens
    under quartet2, card against CPU with TensorDraws injected (the CPU
    pass from `cpu_references`); the quantization noise (quartet2 against
    bf16) and the witness (x one ulp away) on the card. deepseek-v3 does
    not train on one card at its widths (one MoE layer's f32 state,
    parameters, gradients and two moments, is about 180 GB), so its MLA
    backward is held here alone. dev="cpu" rehearses it on the reduced
    config, the CPU against itself."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops

    cuda = dev == "cuda"
    cfg = registry.get("deepseek_v3_671b")
    cfg = cfg if cuda else cfg.reduced()
    m = cfg.mla
    padded = -(-(m.kv_lora_rank + m.qk_rope_head_dim) // 128) * 128  # 640
    b, s = MLA_TRAIN_TOKENS
    log(f"phase 12e: mla_apply forward + backward at deepseek-v3's widths ({b} x "
        f"{s} tokens, quartet2, injected draws), card against CPU")
    t0 = time.perf_counter()
    p, x, x_ulp, target, seed = mla_inputs(torch, cfg)
    real_bwd = ops.quartet2_backward_gemm
    widths, padded_calls = [], []

    def recording_bwd(a, bb, *rest):
        widths.append(int(a.shape[-1]))
        out = real_bwd(a, bb, *rest)
        if a.shape[-1] == padded and a.device.type != "cpu":
            padded_calls.append(((a, bb, *rest), out))
        return out

    res = {"cpu": (cpu_reference("mla") if cuda else
                   mla_pass(torch, cfg, p, x, target, seed, "cpu", "quartet2"))}
    ops.quartet2_backward_gemm = recording_bwd
    try:
        res["card"] = mla_pass(torch, cfg, p, x, target, seed, dev, "quartet2")
    finally:
        ops.quartet2_backward_gemm = real_bwd
    res["card bf16"] = mla_pass(torch, cfg, p, x, target, seed, dev, "bf16")
    res["card x+ulp"] = mla_pass(torch, cfg, p, x_ulp, target, seed, dev, "quartet2")
    wd = sorted(set(widths))
    names = ["x", *p]
    (lc, oc, gc_, _), (lg, og, gg, launches) = res["cpu"], res["card"]
    (_, _, gb, _), (_, ou, gu, _) = res["card bf16"], res["card x+ulp"]
    rel = lambda u, v: float(((u - v).pow(2).mean() / v.pow(2).mean().clamp_min(
        1e-30)).sqrt())
    rms = {n: rel(a, c) for n, a, c in zip(names, gg, gc_)}
    noise = {n: rel(c, bb) for n, c, bb in zip(names, gg, gb)}
    witness = {n: rel(u, c) for n, u, c in zip(names, gu, gg)}
    out_rms, out_witness = rel(og, oc), rel(ou, og)
    finite = all(bool(torch.isfinite(t).all()) for t in (og, *gg))
    log(f"  [{card}] loss card {lg:.8g} / CPU {lc:.8g}; output relative RMS "
        f"{out_rms:.3g} (bar {MLA_TRAIN_REL_RMS}); gradients, card-CPU relative "
        "RMS / quartet2-bf16 noise (bar " + f"{Q2_NOISE_FRACTION}): " + ", ".join(
            f"{n} {rms[n]:.3g} / {noise[n]:.3g}" for n in names))
    log(f"  witness, the card with x one bf16 ulp away from 0 against the card: "
        f"output relative RMS {out_witness:.3g}; gradients relative RMS / "
        "quartet2-bf16 noise: " + ", ".join(
            f"{n} {witness[n]:.3g} / {noise[n]:.3g} ({witness[n] / noise[n]:.3g})"
            for n in names))
    log("  card-CPU distance as a fraction of the noise: " + ", ".join(
        f"{n} {rms[n] / noise[n]:.3g}" for n in names))
    gemm_errs = []
    for args, got in padded_calls:
        want = real_bwd(*(t.cpu() if isinstance(t, torch.Tensor) else t
                          for t in args))
        gemm_errs.append(float((got.cpu() - want).abs().max() / want.abs().max()))
    log(f"  backward GEMM contraction widths on the card: {wd}; the {padded}-wide "
        f"one(s) against the plain composition: max|dC| / max|C| "
        f"{[f'{e:.3g}' for e in gemm_errs]} (bar {BWD_GEMM_RTOL}); launches "
        f"{launches}; {time.perf_counter() - t0:.1f} s")
    if (not finite or out_rms > MLA_TRAIN_REL_RMS
            or any(rms[n] > Q2_NOISE_FRACTION * noise[n] for n in names)):
        fail("12e: mla_apply's forward + backward on the card disagrees with the CPU")
    if padded not in wd:
        fail(f"12e: no backward GEMM contracted over wkv_a's padded {padded} ({wd})")
    if cuda and (not gemm_errs or max(gemm_errs) > BWD_GEMM_RTOL):
        fail(f"12e: the {padded}-wide backward GEMM on the card disagrees with its "
             "plain composition")
    if cuda and any(launches[k] <= 0 for k in ("nvfp4_fos_quant", "fp4_matmul",
                                               "ms_eden_phase1", "ms_eden_phase2")):
        fail(f"12e: a kernel of the training path was not launched: {launches}")
    return {"out_rel_rms": out_rms, "rel_rms": rms, "noise": noise,
            "witness_out_rel_rms": out_witness, "witness_rel_rms": witness,
            "widths": wd, "padded_gemm_err": gemm_errs, "launches": launches}


def phase_registry(torch, card):
    """Phase 12: 12a-12f. Returns its numbers (with "launches", the sum
    over its main-path runs: 12a's serving, 12c and 12d's quartet2 run) and
    its kernel groups and errors."""
    t0 = time.perf_counter()
    shapes = KernelShapes()
    out = phase_registry_serving(torch, card, shapes)
    groups, errs = phase_group_kernels(torch)
    out["moe_train"] = phase_moe_train(torch, card, shapes)
    out["mla_backward"] = phase_mla_backward(torch, card)
    for k, err in phase_registry_kernels(torch, shapes).items():
        errs[k] = max(errs.get(k, 0.0), err)
    runs = [a[pool] for arch, a in out.items() if arch in REGISTRY_ARCHS
            for pool in ("bf16_pool", "nvfp4_pool") if pool in a]
    runs += [out["llava_prefill"], out["moe_train"]]
    out["launches"] = {k: sum(r["launches"][k] for r in runs)
                       for k in runs[-1]["launches"]}
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 12 took {out['phase_s']:.1f} s; launches on its main paths: "
        f"{out['launches']}")
    return out, groups, errs


# --------------------------------------------------------------------------
# phase 13: the recurrent families (rwkv6-7b, recurrentgemma-9b)
# --------------------------------------------------------------------------

RECURRENT_ARCHS = ("rwkv6_7b", "recurrentgemma_9b")
# 13a-13c depth cuts, for the smoke's time limit only (widths are never
# cut): rwkv6-7b at 8 of its 32 layers, recurrentgemma-9b at 6 of 38 (two
# whole rec, rec, lattn patterns; 9 until phase 16 came). rwkv6 stays at 8:
# at 4 layers its bf16 spec stream left the non-spec one at a near-tie
# (13b holds rwkv6 bitwise, and that holds only where cuBLAS's bf16 GEMMs
# give the verify chunk's rows what single-token steps give them)
RECURRENT_LAYERS = {"rwkv6_7b": 8, "recurrentgemma_9b": 6}
LONG_REQUEST = (2304, 32)    # 13a: recurrentgemma's window-reclaim request
# 13b: (spec_k, draft layers): rwkv's verify chunk of 4 < its WKV chunk of 16
RECURRENT_SPEC = {"rwkv6_7b": (3, 2), "recurrentgemma_9b": (3, 3)}
RECURRENT_SPEC_NEW = 16
RING_ROWS, RING_PROMPT, RING_NEW = 1, 2080, 16   # 13c: past the 2,048 window
RING_MAX_LEN = 2560          # 13c: lattn caches of min(2560, 2048) = a ring
# 13d: #5/#6 at recurrentgemma's lattn heads over 4 x 4,096-token tables
HD256 = dict(h=16, kv=1, hd=256, bs=16)
HD256_LENS = [4096, 4090, 3001, 2600]
HD256_LATTN_LAYERS = 12      # lattn layers of one recurrentgemma-9b decode step
HD256_WINDOWS = {"5g/6f recurrentgemma decode hd256 window 2048": 2048,
                 "5h/6g 4 x 4,096 tokens hd256 window 64": 64}
# 13e: full widths, depth cut to one pattern (3 layers) and 2 layers
RECURRENT_TRAIN_LAYERS = {"rwkv6_7b": 2, "recurrentgemma_9b": 3}
RECURRENT_TRAIN_ARGS = ["--scheme", "quartet2", "--steps", "2", "--seq", "256",
                        "--batch", "4", "--lr", "2e-3", "--log-every", "1"]


def recurrent_cfg(arch, dev, layers):
    """The registry's config cut to `layers` on the card; the reduced config
    (its own depth) for a CPU rehearsal."""
    from repro_torch.configs import registry
    cfg = registry.get(arch)
    return dataclasses.replace(cfg, n_layers=layers) if dev == "cuda" else cfg.reduced()


def recurrent_prompts(torch, vocab, seed, n=4):
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(16, 65, (n,), generator=g).tolist()
    return [torch.randint(0, vocab, (m,), generator=g).tolist() for m in lens]


def long_window_request(torch, card, cfg, params, dev="cuda"):
    """13a: one recurrentgemma request of LONG_REQUEST tokens through an
    engine of one slot (bf16 pool, prequantized weights): its lattn window
    (the pool's only token mixer) must return blocks to the free list while
    the request still runs; every block free at the end."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    n_prompt, n_new = LONG_REQUEST if dev == "cuda" else (80, 8)
    window = cfg.griffin.window
    max_len = -(-(n_prompt + n_new) // 256) * 256
    eng = ServeEngine(cfg, params, EngineConfig(
        n_slots=1, max_len=max_len, block_size=16, prefill_chunk=16,
        scheme="quartet2", prequant=False, device=dev))
    if eng.pool.window != window:
        fail(f"13a: the pool's reclaim window is {eng.pool.window}, not {window}")
    g = torch.Generator().manual_seed(1310)
    eng.submit(Request(torch.randint(0, cfg.vocab, (n_prompt,),
                                     generator=g).tolist(), n_new))
    ops.reset_launches()
    held, t0 = [], time.perf_counter()
    while eng.has_work():
        eng.step()
        if eng.slots[0].req is not None:
            held.append((eng.pool.length(0),
                         eng.pool.n_blocks - eng.pool.free_block_count))
    cuda_sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    most = max(b for _, b in held)
    length, blocks = held[-1]
    need = -(-length // 16)
    if not blocks < need or most > -(-(window + 16) // 16) + 2:
        fail(f"13a: no window reclaim: {blocks} blocks held at {length} tokens "
             f"(most {most})")
    if eng.pool.free_block_count != eng.pool.n_blocks:
        fail("13a: blocks leaked after the long request")
    if dev == "cuda" and launches["paged_gqa"] <= 0:
        fail(f"13a: the long request launched no #5: {launches}")
    log(f"  [{card}] {cfg.name} one request of {n_prompt} + {n_new} tokens "
        f"(window {window}, pool of {eng.pool.n_blocks} blocks of 16): at "
        f"{length} tokens it holds {blocks} blocks ({need} without reclaim), "
        f"at most {most} held at once; every block free after it; "
        f"{eng.stats['prefill_steps']} prefill + {eng.stats['decode_steps']} "
        f"decode steps in {wall:.1f} s")
    return {"prompt": n_prompt, "new": n_new, "blocks_at_end": blocks,
            "blocks_without_reclaim": need, "most_blocks": most,
            "wall_s": wall, "launches": launches}


def recurrent_spec(torch, card, cfg, params, prompts, dev="cuda"):
    """13b under bf16 over raw weights: the non-speculative engine with its
    margins recorded, then the speculative one (RECURRENT_SPEC); rwkv6's
    stream must be bitwise the non-speculative one (its verify chunk stays
    on the per-token WKV path), recurrentgemma's equal by the tie rule; in
    every round with a rejecting slot the rows `restore_states` writes back
    must be the snapshot's, bitwise."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Request
    from repro_torch.serve.kv_pool import KVPool, state_leaves

    k, draft = RECURRENT_SPEC["rwkv6_7b" if cfg.rwkv else "recurrentgemma_9b"]
    if dev != "cuda":
        draft = 1
    new = RECURRENT_SPEC_NEW
    base_eng = spec_engine(cfg, params, dev, scheme="bf16", spec_k=0)
    margins = margin_recorder(base_eng)
    for p in prompts:
        base_eng.submit(Request(p, new))
    t0 = time.perf_counter()
    base = {r.req_id: r.tokens for r in base_eng.run()}
    cuda_sync(torch, dev)
    base_wall = time.perf_counter() - t0
    restored, real = [], KVPool.restore_states

    def checked(pool, snapshot, slots):
        real(pool, snapshot, slots)
        if slots and snapshot is not None:
            rows = list(slots)
            same = all(torch.equal(leaf[:, rows], snap[:, rows]) for leaf, snap
                       in zip(state_leaves(pool.caches), snapshot))
            restored.append(same)

    KVPool.restore_states = checked
    ops.reset_launches()
    try:
        eng, spec, wall = spec_run(torch, cfg, params, prompts, new, dev,
                                   scheme="bf16", spec_k=k, draft_layers=draft)
    finally:
        KVPool.restore_states = real
    launches = dict(ops.LAUNCHES)
    st = eng.stats
    nums = spec_numbers(st, wall)
    equal, compared = tie_rule(spec, base, margins, new)
    agree, first = agreement(spec, base)
    rwkv = cfg.rwkv is not None
    log(f"  13b [{card}] {cfg.name} bf16, spec_k {k} over {draft} draft layers: "
        f"acceptance {nums['acceptance']:.3f}, {nums['tokens_per_slot_round']:.2f} "
        f"tokens a slot a round, decode {nums['decode_tok_s']:.2f} tok/s (non-spec "
        f"wall {base_wall:.1f} s, spec {wall:.1f} s); spec against non-spec "
        f"{'bitwise' if spec == base else 'not bitwise'} ({agree:.1%} before each "
        f"row's first difference {first}); tie rule: {compared} of "
        f"{len(prompts) * new} compared, {'all' if equal else 'not all'} equal; "
        f"{len(restored)} state restores, "
        f"{'all' if all(restored) else 'not all'} bitwise the snapshot")
    if not restored or not all(restored):
        fail(f"13b {cfg.name}: no rejected round, or a restore differs from "
             "its snapshot")
    if rwkv and spec != base:
        fail(f"13b {cfg.name}: the bf16 spec stream is not the non-spec stream")
    if not equal:
        fail(f"13b {cfg.name}: the spec stream differs before a near-tie")
    return {"spec_k": k, "draft_layers": draft, **nums, "bitwise": spec == base,
            "compared": compared, "agreement": agree, "first_diff": first,
            "restores": len(restored), "launches": launches}


def recurrent_ring(torch, card, cfg, params, dev="cuda"):
    """13c: `greedy_generate` on recurrentgemma under bf16 with ring caches
    (RING_ROWS prompts of RING_PROMPT tokens, past the window: the prefill
    rolls, decode wraps), against the paged engine over the same prompts
    by the tie rule."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.decode import greedy_generate
    from repro_torch.serve.engine import Request

    rows, n, new = (RING_ROWS, RING_PROMPT, RING_NEW) if dev == "cuda" else (2, 40, 6)
    max_len = RING_MAX_LEN if dev == "cuda" else 64
    cap = lm.init_cache(cfg, 1, max_len, device="meta")[0]["l2"]["kv"][0].shape[2] - 1
    if cap != cfg.griffin.window:
        fail(f"13c: the lattn cache holds {cap} positions, not a ring of "
             f"{cfg.griffin.window}")
    g = torch.Generator().manual_seed(1320)
    toks = torch.randint(0, cfg.vocab, (rows, n), generator=g)
    ops.reset_launches()
    t0 = time.perf_counter()
    ring = greedy_generate(params, cfg, "bf16", toks.to(dev), new,
                           max_len=max_len, device=dev).tolist()
    cuda_sync(torch, dev)
    ring_wall = time.perf_counter() - t0
    if dev == "cuda":
        torch.cuda.empty_cache()
    eng = spec_engine(cfg, params, dev, scheme="bf16", spec_k=0, n_slots=rows,
                      max_len=max_len)
    margins = margin_recorder(eng)
    for row in toks.tolist():
        eng.submit(Request(row, new))
    t0 = time.perf_counter()
    paged = {r.req_id: r.tokens for r in eng.run()}
    cuda_sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    got = dict(enumerate(ring))
    equal, compared = tie_rule(got, paged, margins, new)
    agree, first = agreement(got, paged)
    log(f"  13c [{card}] greedy_generate over ring caches ({rows} x {n} tokens, "
        f"window {cfg.griffin.window} = cache of {cap}) in {ring_wall:.1f} s "
        f"against the paged engine ({wall:.1f} s): {agree:.1%} before each "
        f"row's first difference {first}; tie rule: {compared} of {rows * new} "
        f"compared, {'all' if equal else 'not all'} equal")
    if not equal:
        fail("13c: the ring loop's stream differs from the engine's before a "
             "near-tie")
    return {"rows": rows, "prompt": n, "new": new, "ring_wall_s": ring_wall,
            "engine_wall_s": wall, "compared": compared, "agreement": agree,
            "first_diff": first, "launches": launches}


def phase_recurrent_serving(torch, card, shapes, dev="cuda"):
    """13a-13c: each recurrent config at its published widths, depth cut to
    RECURRENT_LAYERS, raw weights drawn once (13b and 13c run bf16 on them),
    packed once for 13a's quartet2 runs; kernel shapes into `shapes`.
    dev="cpu" rehearses it on the reduced configs."""
    from repro_torch.models import lm
    from repro_torch.serve.prequant import prequantize

    cuda = dev == "cuda"
    mem = (lambda: torch.cuda.memory_allocated()) if cuda else (lambda: 0)
    out = {}
    for i, arch in enumerate(RECURRENT_ARCHS):
        cfg = recurrent_cfg(arch, dev, RECURRENT_LAYERS[arch])
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        base = mem()
        t0 = time.perf_counter()
        raw = lm.init(cfg, torch.Generator(device=dev).manual_seed(130 + i), dev)
        packed = prequantize(raw, cfg, "quartet2")
        cuda_sync(torch, dev)
        a = {"layers": cfg.n_layers, "init_s": time.perf_counter() - t0,
             "weight_bytes": mem() - base, "packed_bytes": packed_bytes(packed)}
        log(f"phase 13a: {cfg.name} at its published widths, {cfg.n_layers} layers: "
            f"drawn and packed in {a['init_s']:.1f} s, {a['weight_bytes'] / 2**30:.2f} "
            f"GiB resident (raw f32 and packed), {a['packed_bytes'] / 2**30:.2f} GiB "
            "packed")
        prompts = recurrent_prompts(torch, cfg.vocab, 130 + i)
        a["prompt_lens"] = [len(p) for p in prompts]
        with shapes:
            a["bf16_pool"] = serve_registry_arch(torch, card, cfg, packed,
                                                 prompts, False, dev)
            if cfg.griffin:
                a["nvfp4_pool"] = serve_registry_arch(torch, card, cfg, packed,
                                                      prompts, True, dev)
                a["long"] = long_window_request(torch, card, cfg, packed, dev)
        del packed
        a["spec"] = recurrent_spec(torch, card, cfg, raw, prompts, dev)
        if cfg.griffin:
            a["ring"] = recurrent_ring(torch, card, cfg, raw, dev)
        a["seconds"] = time.perf_counter() - t0
        log(f"  {cfg.name} took {a['seconds']:.1f} s")
        out[arch] = a
        del raw
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def phase_hd256_kernels(torch):
    """13d: #5 and #6 at recurrentgemma-9b's lattn heads (H 16, KV 1, hd 256,
    block 16) against their plain versions under the attention bar, Sq 1 and
    16, windows 2,048 and 64 over 4 x 4,096-token tables (unit-scale K/V, as
    the bf16 cases of phases 3 and 12b), two calls bitwise equal; at 3x K/V
    (chip_smoke's packed cases) #5 within the same bar of float64 attention,
    beside the plain version's own distance. One decode step's calls (12
    lattn layers) timed for each window, with the bound and SDPA."""
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.serve import kv_pool as KV

    log("phase 13d: paged_gqa / paged_gqa_q at hd 256 (recurrentgemma-9b lattn)")
    errs = {"paged_gqa": 0.0, "paged_gqa_q": 0.0}
    groups = {"paged_gqa": {}, "paged_gqa_q": {}}
    maxb = 4096 // 16
    f64 = []
    for w_i, window in enumerate((2048, 64)):
        for sq in (1, 16):
            for packed in (False, True):
                name = "paged_gqa_q" if packed else "paged_gqa"
                kern = ops.paged_gqa_q if packed else ops.paged_gqa
                plain = PA.paged_gqa_q_plain if packed else PA.paged_gqa_plain
                args = gqa_q_case(torch, F, b=4, sq=sq, maxb=maxb, lens=HD256_LENS,
                                  seed=1330 + 2 * w_i + sq, packed=packed,
                                  scale=1.0, **HD256)
                out = kern(*args, window=window)
                again = kern(*args, window=window)
                torch.cuda.synchronize()
                errs[name] = max(errs[name], check_against_plain(
                    torch, name, out, plain(*args, window=window), (),
                    f"hd256 Sq{sq} window {window}"))
                if not torch.equal(out, again):
                    fail(f"{name} hd256 Sq{sq} window {window}: two calls differ")
            q, kp, vp, table, pos = gqa_q_case(
                torch, F, b=4, sq=sq, maxb=maxb, lens=HD256_LENS,
                seed=1340 + 2 * w_i + sq, packed=False, **HD256)
            out = ops.paged_gqa(q, kp, vp, table, pos, window=window).double()
            ref = PA.paged_gqa_plain(q, kp, vp, table, pos, window=window).double()
            truth = f64_attention(torch, q, KV.gather_view(kp, table),
                                  KV.gather_view(vp, table), pos, window)
            bar = 5e-6 + 1e-5 * truth.abs()
            row = {"sq": sq, "window": window,
                   "kernel_vs_f64": (out - truth).abs().max().item(),
                   "plain_vs_f64": (ref - truth).abs().max().item(),
                   "kernel_outside": int(((out - truth).abs() > bar).sum()),
                   "plain_outside": int(((ref - truth).abs() > bar).sum())}
            f64.append(row)
            log(f"  3x K/V, Sq{sq} window {window}: kernel {row['kernel_vs_f64']:.3g} "
                f"from float64 ({row['kernel_outside']} outside the bar), plain "
                f"{row['plain_vs_f64']:.3g} ({row['plain_outside']} outside)")
            if row["kernel_outside"]:
                fail(f"paged_gqa hd256 Sq{sq} window {window}: the kernel lies "
                     "outside the bar around float64 attention")
    for label, window in HD256_WINDOWS.items():
        for packed in (False, True):
            name = "paged_gqa_q" if packed else "paged_gqa"
            calls, sd, nbytes, n_ops = [], [], 0, 0
            for layer in range(HD256_LATTN_LAYERS):
                c = gqa_q_case(torch, F, b=4, sq=1, maxb=maxb, lens=HD256_LENS,
                               seed=1350 + layer, packed=packed, scale=1.0, **HD256)
                q, table, pos = c[0], c[-2], c[-1]
                pools = ((KV.PackedKV(c[1], c[2]), KV.PackedKV(c[3], c[4]))
                         if packed else (c[1], c[2]))
                sd.append(sdpa_yardstick(torch, q, *pools, table, pos, KV, window))
                row_bytes = HD256["kv"] * HD256["hd"] * (0.5625 if packed else 2) * 2
                nb, no = attn_bytes_ops(q, *pools, table, pos, window, row_bytes)
                nbytes, n_ops = nbytes + nb, n_ops + no
                calls.append(c)
            kern = ops.paged_gqa_q if packed else ops.paged_gqa
            plain = PA.paged_gqa_q_plain if packed else PA.paged_gqa_plain
            fn = lambda calls=calls, kern=kern, w=window: [kern(*c, window=w)
                                                           for c in calls]
            sdpa_fn = lambda sd=sd: [f() for f in sd]
            grp = dict(fn=fn, ms=time_ms(torch, fn, 20),
                       plain_ms=time_ms(torch, lambda: [plain(*c, window=window)
                                                        for c in calls], 2),
                       library_ms=time_ms(torch, sdpa_fn, 10),
                       library_profiler_ms=device_ms(torch, sdpa_fn, ""),
                       bytes=nbytes, ops=n_ops, peak=F32_FLOPS,
                       calls=HD256_LATTN_LAYERS)
            p = PA.plan(4, 1, HD256["h"], HD256["kv"], maxb, 16, HD256["hd"])
            log(f"  {name} {label}, one decode step ({HD256_LATTN_LAYERS} lattn "
                f"layers): plan {p.splits} splits, {p.grid} CTAs, row groups "
                f"{p.row_groups}")
            finish_results({name: grp}, errs)
            groups[name][label] = grp
            del calls, sd
        torch.cuda.empty_cache()
    return groups, errs, f64


def f64_attention(torch, q, k, v, pos, window=None):
    """decode_sdpa's attention in float64 over gathered (B, T, KV, d) views:
    causal per absolute position (and windowed), IEEE softmax."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qd = q.double().reshape(b, sq, kvh, h // kvh, hd)
    s = torch.einsum("bqgrd,btgd->bgrqt", qd, k.double()) / hd ** 0.5
    qpos = pos.long()[:, None] + torch.arange(sq, device=q.device)[None]
    kj = torch.arange(k.shape[1], device=q.device)[None, None]
    ok = kj <= qpos[..., None]
    if window is not None:
        ok &= kj > qpos[..., None] - window
    p = torch.softmax(torch.where(ok[:, None, None], s, -1e30), -1)
    return torch.einsum("bgrqt,btgv->bqgrv", p, v.double()).reshape(b, sq, h, -1)


def phase_recurrent_train(torch, card, shapes, arch, dev="cuda"):
    """13e: `arch` at its published widths, RECURRENT_TRAIN_LAYERS layers,
    through `repro_torch.launch.train`'s code path (quartet2, AdamW, batch 4
    x 256, 2 steps), its kernel shapes recorded into `shapes`: losses and
    weights finite, #1-#4 launched, no SR uniform tensor drawn; ms and
    device ms a step, busy share, #1-#4 a step, peak memory; then a reduced
    quartet2 step x3, card against CPU (`phase_train_reference`). dev="cpu"
    rehearses the first part at the reduced size (seq 32)."""
    from repro_torch.configs import registry
    from repro_torch.core import rng
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw

    cuda = dev == "cuda"
    args = ["--arch", arch, *RECURRENT_TRAIN_ARGS]
    if not cuda:
        args += ["--device", "cpu", "--reduced", "--seq", "32"]
    steps = int(args[args.index("--steps") + 1])
    real_get, real_uniform = registry.get, rng.HashDraws.uniform
    cut = dataclasses.replace(real_get(arch), n_layers=RECURRENT_TRAIN_LAYERS[arch])
    cfg = cut if cuda else cut.reduced()
    log(f"phase 13e: training {cut.name} at its published widths, {cfg.n_layers} "
        f"layers (quartet2, AdamW, batch 4 x seq 256, {steps} steps)")
    drawn = []

    def counted_uniform(self, tag, shape, device):
        drawn.append(tuple(shape))
        return real_uniform(self, tag, shape, device)

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    registry.get = lambda name: cut if registry._norm(name) == arch else real_get(name)
    rng.HashDraws.uniform = counted_uniform
    ops.reset_launches()
    try:
        with shapes:
            out, trainer, state = launch_train.run(args)
            cuda_sync(torch, dev)
    finally:
        registry.get, rng.HashDraws.uniform = real_get, real_uniform
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    losses = out["losses"]
    if out["arch"] != cfg.name or len(losses) != steps:
        fail(f"13e: trained {out['arch']} for {len(losses)} steps")
    if not all(h["finite"] for h in trainer.history):
        fail(f"13e: non-finite training loss: {losses}")
    if not all(bool(torch.isfinite(p).all()) for p in adamw.leaves(state.params)):
        fail("13e: non-finite parameters after training")
    path = ("nvfp4_fos_quant", "fp4_matmul", "ms_eden_phase1", "ms_eden_phase2")
    if cuda and any(launches[k] <= 0 for k in path):
        fail(f"13e: a kernel of the training path was not launched: {launches}")
    if drawn:
        fail(f"13e: {len(drawn)} SR uniform tensors drawn, e.g. {drawn[:3]}")
    per_step = {k: launches[k] / steps for k in path}
    log(f"  [{card}] losses {[round(x, 4) for x in losses]}; {out['step_ms']:.1f} "
        f"ms/step (host clock, steps 2-{steps}), peak memory {peak / 2**30:.2f} GiB; "
        f"#1-#4 a step {per_step}")
    prof = profile_train_step(torch, trainer, state, out["step_ms"]) if cuda else None
    res = {"layers": cfg.n_layers, "losses": losses, "step_ms": out["step_ms"],
           "tokens_per_s": out["tokens_per_s"], "peak_mem_bytes": peak,
           "launches": launches, "launches_per_step": per_step, "profile": prof}
    del trainer, state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        res["reduced_vs_cpu"] = phase_train_reference(torch, arch)
    return res


def phase_recurrent(torch, card):
    """Phase 13: 13a-13e, and 13f: #1-#4 held against their plain versions
    at every shape 13a and 13e gave them (12f's checks). Returns its numbers
    (with "launches", the sum over its main-path runs: 13a-13c's serving and
    13e's quartet2 training), its kernel groups and errors."""
    t0 = time.perf_counter()
    shapes = KernelShapes()
    out = phase_recurrent_serving(torch, card, shapes)
    groups, errs, out["hd256_f64"] = phase_hd256_kernels(torch)
    for arch in RECURRENT_ARCHS:
        out[arch]["train"] = phase_recurrent_train(torch, card, shapes, arch)
    for k, err in phase_registry_kernels(torch, shapes, "13f", "13a and 13e").items():
        errs[k] = max(errs.get(k, 0.0), err)
    runs = []
    for arch in RECURRENT_ARCHS:
        a = out[arch]
        runs += [a[key] for key in ("bf16_pool", "nvfp4_pool", "long", "spec",
                                    "ring", "train") if key in a]
    out["launches"] = {k: sum(r["launches"][k] for r in runs)
                       for k in runs[0]["launches"]}
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 13 took {out['phase_s']:.1f} s; launches on its main paths: "
        f"{out['launches']}")
    return out, groups, errs


# --------------------------------------------------------------------------
# phase 14: whisper's encoder-decoder path
# --------------------------------------------------------------------------

# whisper's 30-second window: 1,500 encoder frames, 448 decoder positions
# (arXiv:2212.04356; openai/whisper ModelDimensions n_audio_ctx, n_text_ctx)
WHISPER_FRAMES = 1500
WHISPER_CTX = 448
WHISPER_BATCH = 4          # 14a: rows
WHISPER_PROMPT = 4         # 14a: decoder prompt tokens a row
WHISPER_STEPS = 60         # 14a: greedy decode steps
WHISPER_PROFILE_STEPS = 4  # 14a: decode steps timed, then profiled
WHISPER_TRAIN_BATCH = 8    # 14b: rows of (1,500 frames, 448 tokens)
WHISPER_TRAIN_STEPS = 3
WHISPER_SEED = (14, 1)     # the quantization seed of 14a's forwards


def whisper_launches(layers: int) -> dict:
    """#1-#4 a forward or step of whisper on raw weights (every weight
    quantized where it is used): a decode step runs 10 linears a decoder
    layer (self-attention 4, cross-attention 4 with K/V projected from the
    encoder output anew, MLP 2), the encode + prefill forward 6 an encoder
    layer more; a quantized linear quantizes its activation and its weight
    (#1 x 2) and runs one GEMM; a training step also runs the dX and dW
    GEMMs (#2 x 3), each backward GEMM's two operands through phase 1 and
    both in one phase-2 launch (#3 x 4, #4 x 2)."""
    dec, fwd = 10 * layers, 16 * layers
    return {"decode": {"nvfp4_fos_quant": 2 * dec, "fp4_matmul": dec},
            "prefill": {"nvfp4_fos_quant": 2 * fwd, "fp4_matmul": fwd},
            "train": {"nvfp4_fos_quant": 2 * fwd, "fp4_matmul": 3 * fwd,
                      "ms_eden_phase1": 4 * fwd, "ms_eden_phase2": 2 * fwd}}


class MatmulCalls:
    """Every fp4_matmul call's (M, N, K, out dtype) on the card, in order,
    while a run is inside `with calls:` (the wrapped calls launch and count
    as before): a decode step's 40 GEMMs for row 2g."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.calls, self._real = [], ops.fp4_matmul

        def rec(a, sa, b, sb, ga, gb, out_dtype=None, **kw):
            if a.is_cuda:
                self.calls.append((a.shape[0], b.shape[0], a.shape[1] * 2,
                                   out_dtype))
            return self._real(a, sa, b, sb, ga, gb,
                              *(() if out_dtype is None else (out_dtype,)), **kw)

        ops.fp4_matmul = rec
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.fp4_matmul = self._real


def profile_steps(torch, fn, steps, label):
    """Host ms a call of fn over `steps` calls (synchronized at the end),
    then the same number under torch.profiler: device ms a call and the
    busy share (device over the unprofiled host time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    rows = [(getattr(ev, "self_device_time_total", 0.0), ev.key, ev.count)
            for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    total_us = sum(us for us, _, _ in rows)
    if total_us == 0:
        log(f"  {label}: no device time in key_averages() (not measured)")
        return {"host_ms_per_step": host_ms, "device_ms_per_step": None,
                "busy_share": None}
    dev_ms = total_us / 1e3 / steps
    by_kernel = {name: sum(us for us, key, _ in rows if of_kernel(key, sym))
                 / 1e3 / steps for name, sym in KERNEL_SYMBOLS.items()}
    log(f"  {label}: host {host_ms:.2f} ms a step (unprofiled), device "
        f"{dev_ms:.3f} ms: busy {dev_ms / host_ms:.1%}; by kernel: " + "; ".join(
            f"{us / 1e3 / steps:.4f} ms {n // steps}x {key[:60]}"
            for us, key, n in rows[:6]))
    return {"host_ms_per_step": host_ms, "device_ms_per_step": dev_ms,
            "busy_share": dev_ms / host_ms,
            "kernel_ms": {k: v for k, v in by_kernel.items() if v > 0},
            "top": [(key, us / 1e3 / steps, n // steps) for us, key, n in rows[:10]]}


def whisper_inputs(torch, cfg, batch, frames, tokens, dev, seed):
    """Seeded stub frame embeddings (bf16 normals x 0.3, the reference
    pipeline's `emit_embeds`) and decoder tokens."""
    g = torch.Generator(device=dev).manual_seed(seed)
    emb = (torch.randn((batch, frames, cfg.d_model), generator=g, device=dev)
           * 0.3).bfloat16()
    toks = torch.randint(0, cfg.vocab, (batch, tokens), generator=g, device=dev,
                         dtype=torch.int32)
    return emb, toks


def whisper_generate(torch, cfg, params, emb, prompt, scheme, steps, max_len,
                     dev, shapes=None, matmuls=None):
    """Encode + prefill `prompt` into `init_encdec_cache`, then `steps`
    greedy decode steps through `lm.forward`, each token the argmax of the
    last logits (no host read): the tokens (B, P + steps), each sampling
    step's logits (f32), host s of the prefill and of the decode steps, #1/#2
    launches of each, and a `step()` that runs one more decode step."""
    import contextlib

    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    seed = np.array(WHISPER_SEED, np.uint32)
    b, p = prompt.shape
    cache = lm.init_encdec_cache(cfg, b, max_len, emb.shape[1], device=dev)
    rec = shapes if shapes is not None else contextlib.nullcontext()
    with torch.no_grad(), rec:
        cuda_sync(torch, dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        logits, cache = lm.forward(params, cfg, {"embeds": emb, "tokens": prompt},
                                   scheme, seed, caches=cache, mode="prefill")
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        cuda_sync(torch, dev)
        prefill_s = time.perf_counter() - t0
        prefill_launches = dict(ops.LAUNCHES)
        toks, outs = [prompt, tok[:, None]], [logits[:, -1].float()]
        state = {"tok": tok, "pos": p, "cache": cache}

        def step(keep=None):
            lg, state["cache"] = lm.forward(
                params, cfg, {"tokens": state["tok"][:, None]}, scheme, seed,
                caches=state["cache"], mode="decode", pos=state["pos"])
            state["tok"] = lg[:, -1].argmax(-1).to(torch.int32)
            state["pos"] += 1
            if keep is not None:
                keep[0].append(state["tok"][:, None])
                keep[1].append(lg[:, -1].float())

        ops.reset_launches()
        t0 = time.perf_counter()
        with (matmuls if matmuls is not None else contextlib.nullcontext()):
            step((toks, outs))
        for _ in range(steps - 1):
            step((toks, outs))
        cuda_sync(torch, dev)
        decode_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
    return {"tokens": torch.cat(toks, 1), "logits": outs,
            "prefill_s": prefill_s, "decode_s": decode_s,
            "prefill_launches": prefill_launches, "launches": launches,
            "step": step}


def phase_whisper_serve(torch, card, shapes, dev="cuda"):
    """14a: whisper-tiny at its published widths and depth, seeded raw
    weights, 4 rows of 1,500 stub frames and a 4-token decoder prompt:
    encode + prefill, then 60 greedy decode steps over the cached encoder
    output, under quartet2 and bf16. Held: #1/#2 launches of the encode +
    prefill forward and of each decode step exact (quartet2), tokens in the
    vocabulary, finite logits; the bf16 decode logits within
    FULL_FORWARD_FRACTION of max|logit| of one train-mode forward over the
    same tokens. Reported: decoder tok/s, host and device ms a decode step,
    busy share; then a reduced step and a reduced quartet2 train step x3,
    card against CPU. dev="cpu" rehearses the logic at the reduced size
    (30 frames, 6 steps)."""
    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.models import lm
    cuda = dev == "cuda"
    cfg = registry.get("whisper_tiny") if cuda else registry.get("whisper_tiny").reduced()
    frames, steps = (WHISPER_FRAMES, WHISPER_STEPS) if cuda else (30, 6)
    log(f"phase 14a: {cfg.name} ({cfg.n_layers} + {cfg.n_layers} layers, d "
        f"{cfg.d_model}, vocab {cfg.vocab}), {WHISPER_BATCH} x {frames} frames, "
        f"a {WHISPER_PROMPT}-token prompt, {steps} greedy decode steps")
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(14), dev)
    emb, prompt = whisper_inputs(torch, cfg, WHISPER_BATCH, frames,
                                 WHISPER_PROMPT, dev, 141)
    want = whisper_launches(cfg.n_layers)
    out = {}
    for scheme in ("quartet2", "bf16"):
        whisper_generate(torch, cfg, params, emb, prompt, scheme, 2,
                         WHISPER_CTX, dev)  # warm-up
        matmuls = MatmulCalls() if scheme == "quartet2" and cuda else None
        r = whisper_generate(torch, cfg, params, emb, prompt, scheme, steps,
                             WHISPER_CTX, dev,
                             shapes if scheme == "quartet2" else None, matmuls)
        toks = r["tokens"]
        if toks.shape != (WHISPER_BATCH, WHISPER_PROMPT + steps + 1) or not (
                (toks >= 0) & (toks < cfg.vocab)).all():
            fail(f"14a ({scheme}): tokens of shape {tuple(toks.shape)} or "
                 "outside the vocabulary")
        if not all(bool(torch.isfinite(x).all()) for x in r["logits"]):
            fail(f"14a ({scheme}): non-finite logits")
        per_step = {k: r["launches"][k] / steps for k in ("nvfp4_fos_quant",
                                                          "fp4_matmul")}
        res = {"prefill_s": r["prefill_s"], "decode_s": r["decode_s"],
               "decode_tok_s": WHISPER_BATCH * steps / r["decode_s"],
               "decode_step_ms": r["decode_s"] / steps * 1e3,
               "launches": r["launches"], "prefill_launches": r["prefill_launches"],
               "launches_per_step": per_step}
        if cuda and scheme == "quartet2":
            pre = {k: r["prefill_launches"][k] for k in want["prefill"]}
            if pre != want["prefill"] or per_step != want["decode"]:
                fail(f"14a: #1/#2 launches: encode + prefill {pre}, a decode "
                     f"step {per_step}; predicted {want['prefill']} and "
                     f"{want['decode']}")
            res["decode_matmuls"] = matmuls.calls[:want["decode"]["fp4_matmul"]]
        if cuda:
            res["profile"] = profile_steps(
                torch, r["step"], WHISPER_PROFILE_STEPS,
                f"14a {scheme} decode step")
        if scheme == "bf16":
            with torch.no_grad():
                full = lm.forward(params, cfg, {"embeds": emb,
                                                "tokens": toks[:, :-1]},
                                  "bf16", np.array(WHISPER_SEED, np.uint32),
                                  mode="train")[0].float()
            tol = FULL_FORWARD_FRACTION * float(full.abs().max())
            err = max(float((lg - full[:, WHISPER_PROMPT - 1 + i]).abs().max())
                      for i, lg in enumerate(r["logits"]))
            res.update(vs_full_forward=err, vs_full_forward_tol=tol)
            if not err <= tol:
                fail(f"14a: bf16 decode logits {err:.4g} from the train-mode "
                     f"forward's (bar {tol:.4g})")
        log(f"  14a [{card}] {scheme}: encode + prefill {r['prefill_s'] * 1e3:.1f} ms "
            f"(host, launches {r['prefill_launches']['nvfp4_fos_quant']} / "
            f"{r['prefill_launches']['fp4_matmul']}), decode {res['decode_tok_s']:.1f} "
            f"tok/s ({res['decode_step_ms']:.2f} ms a step, host); #1/#2 a step "
            f"{per_step}" + (f"; decode logits {res['vs_full_forward']:.4g} from "
                             f"the train forward's (bar {tol:.4g})"
                             if scheme == "bf16" else ""))
        out[scheme] = res
        del r
    del params, emb
    if cuda:
        torch.cuda.empty_cache()
        out["reduced_vs_cpu"] = whisper_reduced_vs_cpu(torch)
        out["train_reduced_vs_cpu"] = phase_train_reference(torch, "whisper_tiny")
    return out


def whisper_reduced_vs_cpu(torch):
    """Reduced whisper, encode + prefill of 8 tokens and 3 decode steps,
    the card against the CPU (same weights, frames and tokens), with
    phase 3's bars for a reduced step: bf16 within 2e-2 of max|dlogit|
    (summation order only), quartet2 below 0.3 relative RMS."""
    from repro_torch.configs import registry
    from repro_torch.models import lm
    cfg = registry.get("whisper_tiny").reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(15), "cpu")
    emb, toks = whisper_inputs(torch, cfg, 2, 30, 11, "cpu", 151)
    res = {}
    for scheme in ("bf16", "quartet2"):
        outs = {}
        for d in ("cpu", "cuda"):
            p = to_device(params, d)
            r = whisper_generate(torch, cfg, p, emb.to(d), toks[:, :8].to(d),
                                 scheme, 3, 32, d)
            outs[d] = [x.cpu() for x in r["logits"]]
        worst_abs = max((a - b).abs().max().item()
                        for a, b in zip(outs["cuda"], outs["cpu"]))
        worst_rel = max(((a - b).pow(2).mean() / b.pow(2).mean()).sqrt().item()
                        for a, b in zip(outs["cuda"], outs["cpu"]))
        log(f"  reduced {cfg.name} encode + prefill + 3 decode steps, {scheme}: "
            f"card vs CPU max|dlogit| {worst_abs:.3g}, rel RMS {worst_rel:.3g}")
        if (not all(torch.isfinite(a).all() for a in outs["cuda"])
                or (scheme == "bf16" and worst_abs > 2e-2) or worst_rel > 0.3):
            fail(f"reduced whisper ({scheme}): card disagrees with the CPU")
        res[scheme] = {"max_abs": worst_abs, "rel_rms": worst_rel}
    return res


class FixedBatch:
    """A corpus whose every batch is the one given (profile_train_step's
    `trainer.corpus`)."""

    def __init__(self, batch):
        self.batch = batch

    def batch_at(self, step):
        return self.batch


def phase_whisper_train(torch, card, shapes, dev="cuda"):
    """14b: whisper-tiny training at its published widths through
    `make_train_step` (quartet2, AdamW, warmup-cosine at base lr 2e-3),
    batch 8 x (1,500 stub frames into the encoder, 448 tokens into the
    decoder), 3 steps, kernel shapes recorded into `shapes`: losses and
    weights finite, #1-#4 a step exactly as `whisper_launches` predicts;
    ms and device ms a step, busy share, peak memory. dev="cpu" rehearses
    it at the reduced size (batch 2 x (30 frames, 16 tokens))."""
    import types

    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    cuda = dev == "cuda"
    cfg = registry.get("whisper_tiny") if cuda else registry.get("whisper_tiny").reduced()
    b, frames, seq = ((WHISPER_TRAIN_BATCH, WHISPER_FRAMES, WHISPER_CTX) if cuda
                      else (2, 30, 16))
    log(f"phase 14b: training {cfg.name}, quartet2, AdamW, batch {b} x ({frames} "
        f"frames, {seq} tokens), {WHISPER_TRAIN_STEPS} steps")
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    init, step = make_train_step(cfg, "quartet2", base_lr=2e-3,
                                 total_steps=WHISPER_TRAIN_STEPS)
    state = init(lm.init(cfg, torch.Generator(device=dev).manual_seed(142), dev))
    emb, toks = whisper_inputs(torch, cfg, b, frames, seq + 1, dev, 143)
    batch = {"embeds": emb, "tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    losses, dts = [], []
    ops.reset_launches()
    with shapes:
        for _ in range(WHISPER_TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))  # the step's host sync
            dts.append(time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if not all(np.isfinite(losses)):
        fail(f"14b: non-finite training loss: {losses}")
    if not all(bool(torch.isfinite(p).all()) for p in adamw.leaves(state.params)):
        fail("14b: non-finite parameters after training")
    want = whisper_launches(cfg.n_layers)["train"]
    per_step = {k: launches[k] / WHISPER_TRAIN_STEPS for k in want}
    if cuda and per_step != want:
        fail(f"14b: #1-#4 a step {per_step}, predicted {want}")
    step_ms = sum(dts[1:]) / len(dts[1:]) * 1e3
    log(f"  14b [{card}] losses {[round(x, 4) for x in losses]}; {step_ms:.1f} ms "
        f"a step (host clock, steps 2-{WHISPER_TRAIN_STEPS}), "
        f"{b * seq / step_ms * 1e3:.0f} decoder tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB; #1-#4 a step {per_step}")
    prof = None
    if cuda:
        trainer = types.SimpleNamespace(corpus=FixedBatch(batch), train_step=step)
        prof = profile_train_step(torch, trainer, state, step_ms)
    res = {"losses": losses, "step_ms": step_ms, "peak_mem_bytes": peak,
           "launches": launches, "launches_per_step": per_step, "profile": prof,
           "tokens_per_s": b * seq / step_ms * 1e3}
    del state, batch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return res


def whisper_decode_group(torch, calls):
    """Row 2g: one 14a quartet2 decode step's 40 GEMMs ((M, N, K) as the
    step gave them: M = 4 a row, the cross K/V at M = 4 x 1,500) timed on
    seeded 4/6-quantized operands, with the plain version, `torch.matmul`
    on the same bf16 block values and the bound."""
    from repro_torch.kernels import fp4_matmul as FM
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(144)
    ops_calls = []
    for m, n, k, dt in calls:
        a = ops.nvfp4_fos_quant(torch.randn((m, k), generator=g,
                                            device="cuda").bfloat16())
        w = ops.nvfp4_fos_quant(torch.randn((n, k), generator=g, device="cuda")
                                * k ** -0.5)
        ops_calls.append((a, w, dt if dt is not None else torch.float32))
    log(f"  2g: fp4_matmul over one whisper decode step's {len(calls)} GEMMs "
        f"(M = {sorted({c[0] for c in calls})}):")
    return matmul_group(torch, FM, ops, ops_calls, 5)


def phase_whisper(torch, card):
    """Phase 14: 14a, 14b, and 14f: #1-#4 held against their plain versions
    at every shape 14a and 14b gave them (12f's checks), and row 2g. Returns
    its numbers (with "launches", the sum over its main-path runs: 14a's
    quartet2 and bf16 decoding and 14b's training), its kernel groups and
    errors."""
    t0 = time.perf_counter()
    shapes = KernelShapes()
    out = {"serve": phase_whisper_serve(torch, card, shapes)}
    out["train"] = phase_whisper_train(torch, card, shapes)
    errs = phase_registry_kernels(torch, shapes, "14f", "14a and 14b")
    groups = {"fp4_matmul": {"whisper_decode_step": whisper_decode_group(
        torch, out["serve"]["quartet2"].pop("decode_matmuls"))}}
    runs = [out["serve"]["quartet2"], out["serve"]["bf16"], out["train"]]
    out["launches"] = {k: sum(r["launches"][k] for r in runs)
                       for k in runs[0]["launches"]}
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 14 took {out['phase_s']:.1f} s; launches on its main paths: "
        f"{out['launches']}")
    return out, groups, errs


# --------------------------------------------------------------------------
# phase 15: disaggregated prefill/decode serving
# --------------------------------------------------------------------------

DISAGG_NEW = 32         # 15a: new tokens a request
DISAGG_MAX_LEN = 128    # 15a: prompts of 16-64 tokens + 32 new
DISAGG_RUNS = (("bf16", False), ("bf16", True), ("quartet2", False))


def disagg_prompts(torch, vocab, n=8):
    """15a's traffic: 8 prompts of 16-64 tokens from seed 15."""
    g = torch.Generator().manual_seed(15)
    lens = torch.randint(16, 65, (n,), generator=g).tolist()
    return [torch.randint(0, vocab, (k,), generator=g).tolist() for k in lens]


def disagg_econf(dev, **kw):
    from repro_torch.serve.engine import EngineConfig
    return EngineConfig(**{**dict(n_slots=4, max_len=DISAGG_MAX_LEN,
                                  block_size=16, prefill_chunk=16,
                                  scheme="quartet2", device=dev), **kw})


def timed_serve(torch, eng, prompts, max_new, dev):
    """`prompts` through `eng` (a ServeEngine or an EnginePair), each
    token's host time taken at the token hook: ({id: tokens}, TTFT s of
    each request, inter-token gaps s, wall s)."""
    from repro_torch.serve.engine import Request
    times = {}

    def hook(req, new, result):
        now = time.perf_counter()
        times.setdefault(req.req_id, []).extend([now] * len(new))

    eng.token_hook = hook
    reqs = [Request(list(p), max_new) for p in prompts]
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    res = {r.req_id: r.tokens for r in eng.run()}
    cuda_sync(torch, dev)
    wall = time.perf_counter() - t0
    eng.token_hook = None
    if sorted(res) != [r.req_id for r in reqs] or any(
            len(t) != max_new for t in res.values()):
        fail("15: a request was not served whole")
    ttft = [times[r.req_id][0] - r.arrival_s for r in reqs]
    gaps = [b - a for r in reqs for a, b in zip(times[r.req_id],
                                                  times[r.req_id][1:])]
    return res, ttft, gaps, wall


def instrument_pair(pair):
    """Host s of each export (the prefill worker's handoff tick over the
    handoffs it made) and each import (`_try_admit_handoff`), and the
    payload bytes the exports read."""
    st = {"export_s": [], "import_s": [], "bytes": 0}
    pe, de = pair.prefill, pair.decode
    tick, admit, read = pe._handoff_tick, de._try_admit_handoff, pe.pool.read_block_host

    def timed_tick():
        n0, t0 = pe.stats["handoffs"], time.perf_counter()
        out = tick()
        n = pe.stats["handoffs"] - n0
        if n:
            st["export_s"] += [(time.perf_counter() - t0) / n] * n
        return out

    def timed_admit(h):
        t0 = time.perf_counter()
        ok = admit(h)
        if ok:
            st["import_s"].append(time.perf_counter() - t0)
        return ok

    def counted_read(block, non_blocking=False):
        payload, nbytes = read(block, non_blocking)
        st["bytes"] += nbytes
        return payload, nbytes

    pe._handoff_tick, de._try_admit_handoff = timed_tick, timed_admit
    pe.pool.read_block_host = counted_read
    return st


def pair_conserved(torch, pair, dev, label):
    """Both pools hold no block and every payload buffer is back on the
    prefill pool's host free list once its copies have run."""
    cuda_sync(torch, dev)
    pe, de = pair.prefill, pair.decode
    pe.pool.poll_host()
    if pair.has_work():
        fail(f"{label}: the pair still has work")
    if (pe.pool.free_block_count != pe.pool.n_blocks
            or de.pool.free_block_count != de.pool.n_blocks):
        fail(f"{label}: blocks held: prefill {pe.pool.n_blocks - pe.pool.free_block_count}"
             f", decode {de.pool.n_blocks - de.pool.free_block_count}")
    if len(pe.pool._host_free) != pe.pool.host_allocs or de.pool.host_allocs:
        fail(f"{label}: {pe.pool.host_allocs - len(pe.pool._host_free)} payload "
             "buffers not returned")


def resident(torch, build, dev):
    """(build(), device bytes it left allocated)."""
    gc.collect()
    cuda_sync(torch, dev)
    base = torch.cuda.memory_allocated() if dev == "cuda" else 0
    obj = build()
    cuda_sync(torch, dev)
    return obj, (torch.cuda.memory_allocated() - base if dev == "cuda" else 0)


def phase_disagg_streams(torch, card, cfg, params, prompts, dev="cuda"):
    """15a: phase 15's traffic (8 requests of 16-64 tokens, 32 new, 4
    slots) through the single engine and through `make_disagg_pair`, under
    bf16 over the bf16 and the NVFP4 pool and under quartet2 over the bf16
    pool. Held: the pair's bf16 streams equal the single engine's bitwise
    (or, should cuBLAS pick other algorithms, by the tie rule; which one is
    printed); every block of both pools free and every payload buffer back
    at the end; a handoff for each request; no prefill forward on the
    decode worker and no decode step on the prefill worker; the pool's
    attention kernel launched (and #1/#2 under quartet2). Reported:
    handoff bytes a request, host ms an export and an import, TTFT and
    the inter-token gap (p50/p99), pair against single, resident device
    bytes of each and the pair's pinned payload bytes; quartet2's
    agreement with the single engine (the per-tensor activation absmax
    couples a decode step's rows, and a handed-off request joins the
    decode batch a tick later, so it is not held)."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.frontend import make_disagg_pair
    out, launch_runs = {}, []
    for scheme, kv_quant in DISAGG_RUNS:
        pool = "NVFP4 pool" if kv_quant else "bf16 pool"
        econf = disagg_econf(dev, scheme=scheme, kv_quant=kv_quant)
        for build in (lambda: ServeEngine(cfg, params, econf),
                      lambda: make_disagg_pair(cfg, params, econf)):
            timed_serve(torch, build(), prompts[:2], 2, dev)  # warm-up
        mono, mono_bytes = resident(torch, lambda: ServeEngine(cfg, params, econf),
                                    dev)
        margins = margin_recorder(mono)
        m_res, m_ttft, m_gaps, m_wall = timed_serve(torch, mono, prompts,
                                                    DISAGG_NEW, dev)
        mono_st = dict(mono.stats)
        del mono
        pair, pair_bytes = resident(
            torch, lambda: make_disagg_pair(cfg, params, econf), dev)
        hst = instrument_pair(pair)
        ops.reset_launches()
        p_res, p_ttft, p_gaps, p_wall = timed_serve(torch, pair, prompts,
                                                    DISAGG_NEW, dev)
        launches = dict(ops.LAUNCHES)
        launch_runs.append(launches)
        label = f"15a ({scheme}, {pool})"
        pair_conserved(torch, pair, dev, label)
        pe, de = pair.prefill, pair.decode
        if (pe.stats["handoffs"] != len(prompts) or de.stats["prefill_steps"]
                or pe.stats["decode_steps"]):
            fail(f"{label}: handoffs {pe.stats['handoffs']} of {len(prompts)}, "
                 f"decode-worker prefill forwards {de.stats['prefill_steps']}, "
                 f"prefill-worker decode steps {pe.stats['decode_steps']}")
        kernel = "paged_gqa_q" if kv_quant else "paged_gqa"
        need = [kernel] + (["nvfp4_fos_quant", "fp4_matmul"]
                           if scheme == "quartet2" else [])
        if dev == "cuda" and any(launches[k] <= 0 for k in need):
            fail(f"{label}: a kernel of the path was not launched: {launches}")
        bitwise = p_res == m_res
        agree, first = agreement(p_res, m_res)
        equal, compared = tie_rule(p_res, m_res, margins, DISAGG_NEW)
        tie_met = equal and compared >= len(prompts) * DISAGG_NEW // 2
        if scheme == "bf16" and not (bitwise or tie_met):
            fail(f"{label}: the pair's streams differ from the single engine's "
                 f"past the tie rule (first differing token by request {first})")
        exported = sum(-(-len(p) // 16) for p in prompts)
        r = {"bitwise": bitwise, "tie_rule_met": tie_met, "agreement": agree,
             "first_diff": first, "handoff_bytes_per_request": hst["bytes"] / len(prompts),
             "export_ms": median(hst["export_s"]) * 1e3,
             "import_ms": median(hst["import_s"]) * 1e3,
             "ttft_s": dict(zip(("p50", "p99"), quantiles(p_ttft))),
             "gap_s": dict(zip(("p50", "p99"), quantiles(p_gaps))),
             "single_ttft_s": dict(zip(("p50", "p99"), quantiles(m_ttft))),
             "single_gap_s": dict(zip(("p50", "p99"), quantiles(m_gaps))),
             "decode_tok_s": de.stats["decode_tokens"] / de.stats["decode_s"],
             "wall_s": p_wall, "single_wall_s": m_wall,
             "single_decode_tok_s": mono_st["decode_tokens"] / mono_st["decode_s"],
             "resident_bytes": pair_bytes, "single_resident_bytes": mono_bytes,
             "pinned_payload_bytes": pe.pool.host_allocs * pe.pool.host_block_bytes,
             "payload_buffers": pe.pool.host_allocs, "blocks_exported": exported,
             "launches": launches}
        log(f"  {label} [{card}]: streams "
            + ("bitwise the single engine's" if bitwise else
               f"{'meet' if tie_met else 'miss'} the tie rule ({agree:.1%} before "
               "each row's first difference)")
            + f"; {r['handoff_bytes_per_request'] / 1e3:.1f} kB a handoff, export "
            f"{r['export_ms']:.3f} ms / import {r['import_ms']:.3f} ms (host, "
            f"median); TTFT p50/p99 {r['ttft_s']['p50']:.3f}/{r['ttft_s']['p99']:.3f} s "
            f"(single {r['single_ttft_s']['p50']:.3f}/{r['single_ttft_s']['p99']:.3f}), "
            f"gap p50/p99 {r['gap_s']['p50'] * 1e3:.1f}/{r['gap_s']['p99'] * 1e3:.1f} ms "
            f"(single {r['single_gap_s']['p50'] * 1e3:.1f}/"
            f"{r['single_gap_s']['p99'] * 1e3:.1f}); decode {r['decode_tok_s']:.1f} "
            f"tok/s (single {r['single_decode_tok_s']:.1f}); resident "
            f"{pair_bytes / 2**20:.1f} MiB (single {mono_bytes / 2**20:.1f}), "
            f"{pe.pool.host_allocs} pinned payload buffers for {exported} "
            f"blocks exported ({r['pinned_payload_bytes'] / 2**10:.0f} KiB)")
        out[f"{scheme}_{'nvfp4' if kv_quant else 'bf16'}_pool"] = r
        del pair
    return out, launch_runs


def phase_disagg_cancel(torch, card, cfg, params, prompts, dev="cuda"):
    """15b: bf16 pair, the first 16 tokens of 15a's prompts (one prefill
    chunk each, so prefills outpace decoding and the decode slots fill):
    cancel one request while its handoff is in transit (exported by the
    prefill worker, not yet shipped) and one whose handoff waits on the
    decode worker for a slot, then drain: the other 6 served whole, both
    pools conserved, every payload buffer returned."""
    from repro_torch.serve.engine import Request
    from repro_torch.serve.frontend import make_disagg_pair
    pair = make_disagg_pair(cfg, params, disagg_econf(dev, scheme="bf16"))
    ids = [pair.submit(Request(list(p[:16]), DISAGG_NEW)) for p in prompts]
    while not pair.prefill.handoffs:
        pair.prefill.step()
    in_transit = pair.prefill.handoffs[0].req.req_id
    if not pair.cancel(in_transit):
        fail("15b: the in-transit handoff could not be cancelled")
    for _ in range(10_000):
        if pair.decode.handoff_queue:
            break
        pair.step()
    else:
        fail("15b: no handoff ever waited for a decode slot")
    queued = pair.decode.handoff_queue[-1].req.req_id
    if not pair.cancel(queued):
        fail("15b: the queued handoff could not be cancelled")
    res = {r.req_id: r.tokens for r in pair.run()}
    left = sorted(set(ids) - {in_transit, queued})
    if sorted(res) != left or any(len(t) != DISAGG_NEW for t in res.values()):
        fail(f"15b: served {sorted(res)}, expected {left}")
    if pair.stats["cancelled"] != 2:
        fail(f"15b: {pair.stats['cancelled']} cancellations counted")
    pair_conserved(torch, pair, dev, "15b")
    log(f"  15b [{card}]: cancelled request {in_transit} in transit and {queued} "
        f"queued on the decode worker; the other {len(left)} served whole; both "
        "pools conserved, every payload buffer returned")
    return {"cancelled": [in_transit, queued], "served": len(left)}


def phase_disagg_http(torch, card, cfg, params, prompts, dev="cuda"):
    """15c: bf16, the first 4 of 15a's requests as concurrent SSE clients of
    `CompletionFrontend` over a pair on the bridge's thread: the streams
    bitwise the pair's own `run()`, both pools conserved."""
    from repro_torch.serve.engine import Request
    from repro_torch.serve.frontend import make_disagg_pair
    prompts = prompts[:4]
    econf = disagg_econf(dev, scheme="bf16")
    ref_pair = make_disagg_pair(cfg, params, econf)
    ids = [ref_pair.submit(Request(list(p), DISAGG_NEW)) for p in prompts]
    res = {r.req_id: r.tokens for r in ref_pair.run()}
    want = [res[i] for i in ids]
    pair = make_disagg_pair(cfg, params, econf)
    got, wall, _, launches = streamed(torch, pair, prompts, DISAGG_NEW, dev)
    if [r["tokens"] for r in got] != want:
        fail("15c: SSE streams over the pair differ from its run()")
    pair_conserved(torch, pair, dev, "15c")
    log(f"  15c [{card}]: {len(prompts)} SSE streams over the pair bitwise its "
        f"run(); wall {wall:.2f} s; launches {launches}")
    return {"wall_s": wall, "launches": launches}


def phase_disagg(torch, card, llama_params):
    """Phase 15: disaggregated prefill/decode (15a-15c) on llama-200m's
    first SHARED_LLAMA_LAYERS layers (views of phase 4's weights). Returns
    its numbers, with "launches" the sum over its main-path runs (15a's
    three pairs and 15c's)."""
    t0 = time.perf_counter()
    cfg, params = llama_cut(llama_params)
    log(f"phase 15: disaggregated prefill/decode (llama-200m at {cfg.n_layers} of "
        "10 layers, 4 slots a worker)")
    prompts = disagg_prompts(torch, cfg.vocab)
    out, runs = phase_disagg_streams(torch, card, cfg, params, prompts)
    out["cancel"] = phase_disagg_cancel(torch, card, cfg, params, prompts)
    out["http"] = phase_disagg_http(torch, card, cfg, params, prompts)
    runs.append(out["http"]["launches"])
    out["launches"] = {k: sum(r[k] for r in runs) for k in runs[0]}
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 15 took {out['phase_s']:.1f} s; launches on its main paths: "
        f"{out['launches']}")
    return out


# --------------------------------------------------------------------------
# phase 16: the distribution layer
# --------------------------------------------------------------------------

DP_RANKS = 2                 # ranks sharing the one card over a gloo group
DP_STEPS = 3                 # 16a: steps of phase 5's recipe
DP_COMPRESSED_STEPS = 2      # 16b (3 until phase 17 came): the first step's
                             # leaf errors and the steady step need two
DP_SEQ, DP_BATCH = 256, 8    # the global batch: 4 rows of 256 a rank
# 16a's bar if the ranks are not bitwise the one process: only the f32 head's
# cuBLAS algorithm may differ between processes (relative RMS a leaf)
DP_HEAD_REL_RMS = 1e-5
COMPRESS_MEDIAN_BAR = 0.2    # 16b: tests/test_substrate.py's one-draw bar
# 16b's floor: an SR round trip that were skipped or exact would read 0; an
# H100 measured 0.119-0.129 a leaf, SR's MSE predicts about 0.15
COMPRESS_MEDIAN_FLOOR = 0.05
GPIPE_D, GPIPE_ROWS, GPIPE_MICRO = 2048, 256, 4   # 16c
GPIPE_ATOL = 1e-5            # 16c: tests/test_pipeline.py's bars
GPIPE_COMPRESS_BAR = 0.30


def dp_args(dev, compress):
    """`launch.train`'s command line of 16a (16b with `compress`): phase 5's
    recipe for DP_STEPS steps on DP_RANKS ranks sharing the card over gloo
    (the reduced llama at 16 tokens a row on the CPU)."""
    args = list(TRAIN_ARGS)
    args[args.index("--steps") + 1] = str(DP_COMPRESSED_STEPS if compress
                                          else DP_STEPS)
    args[args.index("--seq") + 1] = str(DP_SEQ if dev == "cuda" else 16)
    args[args.index("--batch") + 1] = str(DP_BATCH)
    args += ["--device", dev, "--dp", str(DP_RANKS), "--backend", "gloo"]
    return args + (["--reduced"] if dev != "cuda" else []) + (
        ["--compress"] if compress else [])


def dp_setup(torch, dev, device, group, microbatches=1):
    """(train_step, fresh state, corpus) of `dp_args`' recipe built here, as
    `launch.train` builds it on every rank (for the one-process run and the
    group of one)."""
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.models import lm
    from repro_torch.train.train_step import make_train_step
    cfg = registry.get("llama_200m")
    cfg = cfg if dev == "cuda" else cfg.reduced()
    init, step = make_train_step(cfg, "quartet2", base_lr=2e-3,
                                 total_steps=DP_STEPS, group=group,
                                 microbatches=microbatches)
    state = init(lm.init(cfg, torch.Generator(device=device).manual_seed(0),
                         device))
    corpus = SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=DP_SEQ if dev == "cuda" else 16,
        global_batch=DP_BATCH))
    return step, state, corpus


def dp_train_run(torch, dev, rank, world, compress, want=None):
    """16a (16b with `compress`) on this rank, through the entry point:
    `launch.train.run(dp_args(...), rank, world)`, what `--dp` runs on each
    spawned rank. Observed from outside (the entry point unchanged): the
    train step it builds is wrapped to read losses, grad norms, host ms and
    the params checksum after each step; `dist.all_reduce_sum_` is timed;
    16b's `compressed_grad_mean` also gives every leaf's error against the
    exact mean on step 0. Then launches, peak memory; 16a: one more step
    profiled by kernel, and rank 0's final params when its checksums are
    not `want` (the one process's)."""
    from repro_torch import dist as D
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.dist import compression as C
    from repro_torch.kernels import ops
    from repro_torch.launch import train as LT
    from repro_torch.optim import adamw

    rec = {"loss": [], "grad_norm": [], "step_ms": [], "checksums": []}
    errs, ar_ms, real = [], [], {}
    exact_sum, real_mean, real_make = (D.all_reduce_sum_, C.compressed_grad_mean,
                                       LT.make_train_step)

    def timed_sum(tensors, grp=None):
        cuda_sync(torch, dev)
        t0 = time.perf_counter()
        exact_sum(tensors, grp)
        cuda_sync(torch, dev)
        ar_ms.append((time.perf_counter() - t0) * 1e3)
        return tensors

    def measured_mean(grads, group, seed):
        got = real_mean(grads, group, seed)
        if not errs:  # step 0: each leaf against the exact mean
            exact = exact_sum([g.float().clone() for g in flatten(grads)], group)
            for c, e in zip(flatten(got), exact):
                if e.numel() >= 16:
                    e /= world
                    errs.append(float((c - e).norm() / e.norm().clamp_min(1e-30)))
        return got

    def make(*a, **kw):
        if dev == "cuda":  # run() has set the rank's device; no params yet
            torch.cuda.reset_peak_memory_stats()
        init, step = real_make(*a, **kw)
        real["step"] = step

        def observed(state, batch):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            rec["loss"].append(float(m["loss"]))
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["grad_norm"].append(float(m["grad_norm"]))
            rec["checksums"].append(D.checksum(adamw.leaves(state.params)))
            return state, m
        return init, observed

    ops.reset_launches()
    D.all_reduce_sum_, C.compressed_grad_mean, LT.make_train_step = (
        timed_sum, measured_mean, make)
    try:
        summary, trainer, state = LT.run(dp_args(dev, compress), rank=rank,
                                         world=world)
    finally:
        D.all_reduce_sum_, C.compressed_grad_mean, LT.make_train_step = (
            exact_sum, real_mean, real_make)
    device = trainer.device
    rec.update(launches=dict(ops.LAUNCHES), all_reduce_ms=ar_ms,
               leaf_rel_err=errs, history_losses=summary["losses"],
               grad_bytes=sum(4 * p.numel() for p in adamw.leaves(state.params)),
               current_device=(torch.cuda.current_device() if dev == "cuda"
                               else None),
               device=str(device),
               peak_mem_bytes=(torch.cuda.max_memory_allocated(device)
                               if dev == "cuda" else 0))
    if not compress:
        if rank == 0 and rec["checksums"] != want:
            rec["params"] = [p.detach().cpu() for p in adamw.leaves(state.params)]
        if dev == "cuda":  # one more step (each rank), profiled by kernel
            trainer.train_step = real["step"]
            rec["profile"] = profile_train_step(
                torch, trainer, state, median(rec["step_ms"][1:]),
                say=log if rank == 0 else (lambda msg: None),
                batch={k: v.to(device) for k, v in trainer.corpus.batch_at(
                    state.step, rank, world).items()})
    return rec


def gpipe_stage(torch):
    from repro_torch.core.linear import qlinear
    return lambda w, x: torch.tanh(qlinear(x, w, None, "quartet2"))


def gpipe_inputs(torch, dev, device, world):
    d, rows = (GPIPE_D, GPIPE_ROWS) if dev == "cuda" else (64, 8)
    g = torch.Generator(device=device).manual_seed(16)
    ws = torch.randn((world, d, d), generator=g, device=device) * d ** -0.5
    return ws, torch.randn((GPIPE_MICRO, rows, d), generator=g, device=device)


def gpipe_run(torch, dev, device, rank, world):
    """16c on this rank: the pipe plain and with NVFP4 boundaries (launches
    and host ms each), against the stages applied in order to each
    microbatch on this rank's device."""
    from repro_torch.dist import pipeline as PP
    from repro_torch.kernels import ops
    stage = gpipe_stage(torch)
    ws, xs = gpipe_inputs(torch, dev, device, world)
    out, ys = {}, {}
    with torch.no_grad():
        for compress in (False, True):
            run = PP.gpipe(stage, world, GPIPE_MICRO, compress=compress)
            ops.reset_launches()
            cuda_sync(torch, dev)
            t0 = time.perf_counter()
            ys[compress] = run(ws[rank: rank + 1], xs)
            cuda_sync(torch, dev)
            out[f"ms_{compress}"] = (time.perf_counter() - t0) * 1e3
            out[f"launches_{compress}"] = dict(ops.LAUNCHES)
        want = []
        for x in xs:
            for s in range(world):
                x = stage(ws[s], x)
            want.append(x)
        want = torch.stack(want)
    out["bitwise"] = torch.equal(ys[False], want)
    out["max_abs_err"] = float((ys[False] - want).abs().max())
    out["compressed_rel"] = float((ys[True] - want).norm() / want.norm())
    out["bubble"] = PP.bubble_fraction(world, GPIPE_MICRO)
    out["ticks"] = GPIPE_MICRO + world - 1
    return out


def dp_rank_body(rank, world, dev, want):
    """One spawned rank of phase 16: 16a, 16b (both through `launch.train.
    run`, which sets the rank's current device) and 16c in one gloo group. A
    rank on the card loads the library phase 2 built (no rebuild). `want`:
    the one process's params checksums after each step. "marks": seconds
    since the group formed at the end of each part."""
    import torch
    from repro_torch import dist as D
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    if dev == "cuda":
        build.library()
    else:
        torch.set_num_threads(1)
    out, marks = {}, {"library": time.perf_counter() - t0}
    out["exact"] = dp_train_run(torch, dev, rank, world, False, want)
    marks["16a"] = time.perf_counter() - t0
    out["compressed"] = dp_train_run(torch, dev, rank, world, True)
    marks["16b"] = time.perf_counter() - t0
    out["gpipe"] = gpipe_run(torch, dev, D.rank_device(dev, rank), rank, world)
    marks["16c"] = time.perf_counter() - t0
    out["marks"] = marks
    return out


def rel_rms(torch, a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def dp_one_process(torch, dev, shapes):
    """16a's comparison run in this process: 2 microbatches over the two
    ranks' shards laid end to end; its kernel shapes into `shapes`."""
    from repro_torch import dist as D
    from repro_torch.optim import adamw
    device = torch.device(dev)
    step, state, corpus = dp_setup(torch, dev, device, None, microbatches=2)
    rec = {"loss": [], "grad_norm": [], "checksums": []}
    with shapes:
        for i in range(DP_STEPS):
            parts = [corpus.batch_at(i, r, DP_RANKS) for r in range(DP_RANKS)]
            batch = {k: torch.cat([p[k] for p in parts]).to(device)
                     for k in parts[0]}
            state, m = step(state, batch)
            rec["loss"].append(float(m["loss"]))
            rec["grad_norm"].append(float(m["grad_norm"]))
            rec["checksums"].append(D.checksum(adamw.leaves(state.params)))
    rec["params"] = [p.detach().cpu() for p in adamw.leaves(state.params)]
    return rec


def phase_dp_exact(torch, card, ranks, dev, one):
    """16a's checks on the ranks' results against the one process's run
    (`dp_one_process`)."""
    runs = [r["exact"] for r in ranks]
    want_launches = {k: v * DP_STEPS for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
    for r, run in enumerate(runs):
        got = {k: run["launches"][k] for k in want_launches}
        if dev == "cuda" and got != want_launches:
            fail(f"16a: rank {r} launched {got}, expected {want_launches}")
        if not all(math.isfinite(x) for x in run["loss"]):
            fail(f"16a: non-finite losses on rank {r}: {run['loss']}")
        if run["history_losses"] != run["loss"]:
            fail(f"16a: rank {r}'s trainer logged {run['history_losses']}, its "
                 f"steps returned {run['loss']}")
        if dev == "cuda" and run["device"] != f"cuda:{run['current_device']}":
            fail(f"16a: rank {r} trained on {run['device']} with current "
                 f"device {run['current_device']}")
    if runs[0]["checksums"] != runs[1]["checksums"] or \
            runs[0]["loss"] != runs[1]["loss"]:
        fail("16a: the ranks' params or losses differ after a step")
    bitwise = (one["checksums"] == runs[0]["checksums"]
               and one["loss"] == runs[0]["loss"]
               and one["grad_norm"] == runs[0]["grad_norm"])
    worst = 0.0 if bitwise else max(
        rel_rms(torch, a, b) for a, b in zip(runs[0]["params"], one["params"]))
    if not bitwise and worst > DP_HEAD_REL_RMS:
        fail(f"16a: 2 ranks against one process of 2 microbatches: params "
             f"{worst:.3g} relative RMS apart (bar {DP_HEAD_REL_RMS}); losses "
             f"{runs[0]['loss']} against {one['loss']}")
    ar = [x for run in runs for x in run["all_reduce_ms"]]
    steady = [x for run in runs for x in run["step_ms"][1:]]
    profs = [run.get("profile") for run in runs]
    split = [None if p is None else {
        "kernels_ms": sum(p["kernel_ms"].values()),
        "other_ms": p["device_ms_per_step"] - sum(p["kernel_ms"].values()),
        "torch_ms": {k: ms for k, (_, ms) in p["torch_launches"].items() if ms},
        "other_top": [(key[:60], ms, n) for key, ms, n in p["top"]
                      if not any(of_kernel(key, KERNEL_SYMBOLS[k])
                                 for k in TRAIN_LAUNCHES_PER_STEP)][:6]}
        for p in profs]
    out = {"bitwise": bitwise, "worst_rel_rms": worst,
           "losses": runs[0]["loss"], "grad_norms": runs[0]["grad_norm"],
           "step_ms": [run["step_ms"] for run in runs],
           "all_reduce_ms": [run["all_reduce_ms"] for run in runs],
           "grad_bytes": runs[0]["grad_bytes"],
           "device_ms": [None if p is None else p["device_ms_per_step"]
                         for p in profs],
           "device_launches": [None if p is None else p["launches"]
                               for p in profs],
           "device_split": split, "profile": profs,
           "peak_mem_bytes": [run["peak_mem_bytes"] for run in runs]}
    log(f"  16a [{card}] 2 ranks x 4 rows against one process of 2 "
        f"microbatches: {'bitwise' if bitwise else f'{worst:.3g} rel RMS'} "
        f"(losses {[round(x, 4) for x in out['losses']]}, grad norms "
        f"{[round(x, 4) for x in out['grad_norms']]}); ranks bitwise equal "
        f"after each of {DP_STEPS} steps; #1-#4 a rank a step "
        f"{ {k: v // DP_STEPS for k, v in runs[0]['launches'].items() if v} }")
    log(f"  16a [{card}] through launch.train.run on each rank (devices "
        f"{[run['device'] for run in runs]}); host ms a step after the first "
        f"{median(steady):.1f} "
        f"(each {[[round(x, 1) for x in run['step_ms']] for run in runs]}); "
        f"the all-reduce (loss + {out['grad_bytes'] / 1e9:.3f} GB of f32 "
        f"grads, gloo on the card's tensor) median {median(ar):.1f} ms; "
        f"device ms of one profiled step a rank "
        f"{[None if x is None else round(x, 2) for x in out['device_ms']]}; "
        f"peak memory a rank "
        f"{[round(x / 2**30, 2) for x in out['peak_mem_bytes']]} GiB")
    for r, sp in enumerate(split):
        if sp is not None:
            log(f"  16a [{card}] rank {r}'s profiled step: #1-#4 "
                f"{sp['kernels_ms']:.2f} ms, every other kernel "
                f"{sp['other_ms']:.2f} ms; PyTorch's by pattern "
                f"{ {k: round(v, 2) for k, v in sp['torch_ms'].items()} }; the "
                f"largest others (name, ms, launches) "
                f"{[(k, round(ms, 2), n) for k, ms, n in sp['other_top']]}")
    return out


def phase_dp_compressed(torch, card, ranks):
    """16b's checks: finite, rank-identical, the step-0 leaf errors."""
    runs = [r["compressed"] for r in ranks]
    if not all(math.isfinite(x) for run in runs for x in run["loss"]):
        fail(f"16b: non-finite losses {[run['loss'] for run in runs]}")
    if runs[0]["checksums"] != runs[1]["checksums"]:
        fail("16b: the ranks' params differ after a compressed step")
    errs = sorted(runs[0]["leaf_rel_err"])
    med = median(errs)
    if not COMPRESS_MEDIAN_FLOOR < med < COMPRESS_MEDIAN_BAR:
        fail(f"16b: the median leaf's compressed mean is {med:.3f} from the "
             f"exact mean (floor {COMPRESS_MEDIAN_FLOOR}, bar "
             f"{COMPRESS_MEDIAN_BAR})")
    steady = [x for run in runs for x in run["step_ms"][1:]]
    log(f"  16b [{card}] compressed DP: losses "
        f"{[round(x, 4) for x in runs[0]['loss']]}, ranks bitwise equal after "
        f"each step; step 0's {len(errs)} leaves of >= 16 elements: compressed "
        f"mean vs exact mean relative error median {med:.4f} (floor "
        f"{COMPRESS_MEDIAN_FLOOR}, bar {COMPRESS_MEDIAN_BAR}), largest {errs[-1]:.4f}, smallest "
        f"{errs[0]:.4f}; host ms a step after the first {median(steady):.1f}")
    return {"losses": runs[0]["loss"], "median_rel_err": med,
            "max_rel_err": errs[-1], "min_rel_err": errs[0],
            "step_ms": [run["step_ms"] for run in runs],
            "all_reduce_ms": [run["all_reduce_ms"] for run in runs]}


def phase_dp_gpipe(torch, card, ranks, dev):
    """16c's checks."""
    runs = [r["gpipe"] for r in ranks]
    ticks = runs[0]["ticks"]
    for r, run in enumerate(runs):
        if not (run["bitwise"] or run["max_abs_err"] < GPIPE_ATOL):
            fail(f"16c: rank {r}'s pipe is {run['max_abs_err']:.3g} from the "
                 f"stages in order (bar {GPIPE_ATOL})")
        if not 0 < run["compressed_rel"] < GPIPE_COMPRESS_BAR:
            fail(f"16c: compressed boundaries {run['compressed_rel']:.3f} "
                 f"relative (bar {GPIPE_COMPRESS_BAR})")
        for c in (False, True):
            got = run[f"launches_{c}"]
            if dev == "cuda" and (got["nvfp4_fos_quant"], got["fp4_matmul"]) \
                    != (2 * ticks, ticks):
                fail(f"16c: rank {r} launched {got} over {ticks} ticks")
    log(f"  16c [{card}] GPipe, 2 stages of tanh(qlinear) at d "
        f"{GPIPE_D if dev == 'cuda' else 64}, {GPIPE_MICRO} microbatches, "
        f"{ticks} ticks (bubble {runs[0]['bubble']:.2f}): "
        f"{'bitwise' if all(r['bitwise'] for r in runs) else 'max err %.3g' % max(r['max_abs_err'] for r in runs)} "
        f"the stages in order; NVFP4 boundaries "
        f"{runs[0]['compressed_rel']:.4f} relative (bar {GPIPE_COMPRESS_BAR}); "
        f"#1/#2 a rank {runs[0]['launches_False']['nvfp4_fos_quant']}/"
        f"{runs[0]['launches_False']['fp4_matmul']}; host ms plain "
        f"{[round(r['ms_False'], 1) for r in runs]}, compressed "
        f"{[round(r['ms_True'], 1) for r in runs]}")
    return {"bubble": runs[0]["bubble"], "ticks": ticks,
            "bitwise": all(r["bitwise"] for r in runs),
            "max_abs_err": max(r["max_abs_err"] for r in runs),
            "compressed_rel": runs[0]["compressed_rel"],
            "ms": [[r["ms_False"], r["ms_True"]] for r in runs]}


def phase_dp_world1(torch, card, dev, shapes):
    """16d in this process, a group of one: NCCL on the card (gloo on the
    CPU). A DP step equals the plain step bitwise over 2 steps (step 0's lr
    is 0); compressed_psum_mean equals _sr_roundtrip for the same uniforms;
    the pipe's stage shapes recorded for 16f."""
    import tempfile
    import torch.distributed as tdist
    from repro_torch import dist as D
    from repro_torch.dist import compression as C
    from repro_torch.optim import adamw
    backend = "nccl" if dev == "cuda" else "gloo"
    device = torch.device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        D.init(backend, 0, 1, f"file://{tmp}/store", timeout_s=120)
        try:
            runs = []
            for group in (tdist.group.WORLD, None):
                step, state, corpus = dp_setup(torch, dev, device, group)
                for i in range(2):
                    batch = {k: v.to(device) for k, v in corpus.batch_at(i).items()}
                    state, m = step(state, batch)
                runs.append((float(m["loss"]), float(m["grad_norm"]),
                             [p.detach().clone() for p in adamw.leaves(state.params)]))
                del state
            same = runs[0][:2] == runs[1][:2] and all(
                torch.equal(a, b) for a, b in zip(runs[0][2], runs[1][2]))
            if not same:
                fail(f"16d: the {backend} DP step at world size 1 is not the "
                     "plain step")
            del runs
            g = torch.Generator(device=device).manual_seed(164)
            x = torch.randn((2048, 2053), generator=g, device=device)
            seed = [16, 4]
            got = C.compressed_psum_mean(x, None, seed, tag=3)
            u = C.rank_draws(seed, 0).uniform(3, (1, C._padded(x.numel())), device)
            want = C._sr_roundtrip(x, u)
            if not torch.equal(got, want):
                fail("16d: compressed_psum_mean at world size 1 is not "
                     "_sr_roundtrip")
        finally:
            D.shutdown()
    ws, xs = gpipe_inputs(torch, dev, device, DP_RANKS)
    with shapes, torch.no_grad():
        gpipe_stage(torch)(ws[0], xs[0])
    log(f"  16d [{card}] {backend} at world size 1: the DP step bitwise the "
        f"plain step (2 steps); compressed_psum_mean bitwise _sr_roundtrip "
        f"(a 2048 x 2053 f32 leaf, padded)")
    return {"backend": backend, "dp_step_bitwise": True,
            "compressed_bitwise": True}


def phase_dp(torch, card, dev="cuda"):
    """Phase 16: 16a-16c on DP_RANKS spawned ranks, checked here; 16d; 16f
    (on the card). Returns its numbers (with "launches", the sum over the
    ranks' runs of 16a, 16b and 16c) and the errors of #1-#4 in 16f."""
    from repro_torch import dist as D
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    log(f"phase 16: the distribution layer, {DP_RANKS} ranks sharing the card "
        f"over gloo (16a DP training, 16b compressed DP, 16c GPipe), 16d NCCL "
        f"at world size 1")
    shapes = KernelShapes()
    one = dp_one_process(torch, dev, shapes)
    if dev == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = D.spawn(dp_rank_body, DP_RANKS, (dev, one["checksums"]),
                    backend="gloo", timeout_s=900)
    spawn_s = time.perf_counter() - t1
    out = {"launches": {k: sum(r[part][f"launches{suffix}"][k]
                               for r in ranks
                               for part, suffix in (("exact", ""),
                                                    ("compressed", ""),
                                                    ("gpipe", "_False"),
                                                    ("gpipe", "_True")))
                        for k in ops.LAUNCHES},
           "ranks_s": spawn_s, "one_process_s": t1 - t0,
           "rank_marks": [r["marks"] for r in ranks]}
    out["16a"] = phase_dp_exact(torch, card, ranks, dev, one)
    out["16b"] = phase_dp_compressed(torch, card, ranks)
    out["16c"] = phase_dp_gpipe(torch, card, ranks, dev)
    del ranks
    gc.collect()
    out["16d"] = phase_dp_world1(torch, card, dev, shapes)
    errs = (phase_registry_kernels(torch, shapes, "16f", "16a and 16c")
            if dev == "cuda" else {})
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 16 took {out['phase_s']:.1f} s (the one process "
        f"{t1 - t0:.1f} s, the ranks {spawn_s:.1f} s, their seconds from the "
        f"group's start {out['rank_marks']}); launches on its main paths: "
        f"{out['launches']}")
    return out, errs


# --------------------------------------------------------------------------
# phase 17: mesh-sharded serving
# --------------------------------------------------------------------------

SHARDED_LAYERS = 4         # llama-200m's first 4 of 10 layers (phase 4's weights)
SHARDED_NEW = 12           # new tokens a request (17a, 17b, 17d)
SHARDED_MAX_LEN = 80       # prompts of 17-49 tokens + 12 new + spec_k 3
SHARDED_LENS = (33, 17, 49, 33)  # a prompt: whole prefill chunks and one token
SHARDED_SPEC = (3, 2)      # 17d: spec_k, draft layers
SHARDED_PROFILE_STEPS = 8  # 17f: full-batch decode steps timed, then profiled
SHARDED_SAMPLING = (0.8, 8)  # 17a's sampled run: temperature, top-k


def sharded_prompts(torch, vocab):
    """Phase 17's traffic: prompts of SHARDED_LENS tokens from seed 17."""
    g = torch.Generator().manual_seed(17)
    return [torch.randint(0, vocab, (k,), generator=g).tolist()
            for k in SHARDED_LENS]


def sharded_engine(cfg, params, dev, **kw):
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    return ServeEngine(cfg, params, EngineConfig(**{**dict(
        n_slots=4, max_len=SHARDED_MAX_LEN, block_size=16, prefill_chunk=16,
        scheme="bf16", prequant=True, device=dev), **kw}))


def sharded_run(torch, eng, prompts, max_new, dev, label, sampling=None,
                placed=None):
    """`prompts` through `eng`: the streams in submission order. Held: every
    request served whole with in-vocabulary tokens; every block of each
    pool (the draft's too) back on its own shard's free list, or held by
    the prefix cache alone. With `placed` (a list) the first tick's slot of
    each request (submission index, or None for a free slot) is appended
    to it."""
    from repro_torch.serve.engine import Request
    from repro_torch.serve.sampling import SamplingParams
    sp = SamplingParams(*sampling) if sampling else SamplingParams()
    ids = [eng.submit(Request(list(p), max_new, sp)) for p in prompts]
    if placed is not None:
        eng.step()
        placed += [None if s.req is None else ids.index(s.req.req_id)
                   for s in eng.slots]
    res = {r.req_id: r.tokens for r in eng.run()}
    cuda_sync(torch, dev)
    if sorted(res) != sorted(ids) or any(
            len(t) != max_new or not all(0 <= x < eng.cfg.vocab for x in t)
            for t in res.values()):
        fail(f"{label}: a request was not served whole")
    held = eng.cache.cached_blocks() if eng.cache is not None else 0
    pools = [eng.pool] + ([eng.draft.pool] if eng.draft is not None else [])
    for i, pool in enumerate(pools):
        if pool.free_block_count + (held if i == 0 else 0) != pool.n_blocks:
            fail(f"{label}: pool blocks leaked ({pool.free_block_count} free of "
                 f"{pool.n_blocks}, {held} cached)")
    return [res[i] for i in ids]


def decision_margins(torch, eng):
    """margin_recorder for greedy and sampled rows alike: the margin of the
    sampler's own decision, argmax of z = top-k-masked logits / t + Gumbel
    noise (the logits themselves at temperature 0), with the noise drawn
    again from the generator's state before the call, times t, so that it
    reads in logit units beside the row's top logit. Returns the dict the
    tie rule reads, {(request, token index): (margin, top logit)}."""
    from repro_torch.serve.sampling import _topk_mask
    margins, phase = {}, [None]
    for name in ("_prefill_tick", "_decode_tick"):
        def tick(_orig=getattr(eng, name), _name=name):
            phase[0] = _name
            return _orig()
        setattr(eng, name, tick)
    sample = eng._sample

    def rec(last_logits):
        state = eng._gen.get_state()
        out = sample(last_logits)
        gen = torch.Generator(device=last_logits.device)
        gen.set_state(state)
        temps = torch.tensor([s.req.sampling.temperature if s.req else 0.0
                              for s in eng.slots], device=last_logits.device)
        topks = torch.tensor([s.req.sampling.top_k if s.req else 0
                              for s in eng.slots], device=last_logits.device)
        lf = last_logits.float()
        u = torch.rand(lf.shape, generator=gen, device=lf.device)
        tiny = torch.finfo(torch.float32).tiny
        noise = -torch.log(-torch.log(u.clamp_min(tiny)))
        t = temps.clamp_min(1e-6)[:, None]
        z = torch.where(temps[:, None] > 0, _topk_mask(lf, topks) / t + noise, lf)
        if z.argmax(dim=-1).tolist() != list(out):
            fail("17: the decision-margin recorder does not redraw the "
                 "sampler's noise")
        top2 = z.topk(2, dim=-1).values
        gap = ((top2[:, 0] - top2[:, 1]) * torch.where(temps > 0, temps, 1.0)).cpu()
        top = lf.max(dim=-1).values.cpu()
        if phase[0] == "_prefill_tick":
            rows = [min(i for i, s in enumerate(eng.slots)
                        if s.state == "prefill")]
        else:
            rows = [i for i, s in enumerate(eng.slots) if s.state == "decode"]
        for i in rows:
            s = eng.slots[i]
            margins[(s.req.req_id, len(s.generated))] = (float(gap[i]),
                                                          float(top[i]))
        return out

    eng._sample = rec
    return margins


def same_or_tie_rule(got, want, margins, max_new, n):
    """(bitwise, tie rule met, share of tokens before each row's first
    difference, first differing index by request): 9b's and 15a's rule for
    bf16 streams whose steps run at other row counts."""
    g, w = dict(enumerate(got)), dict(enumerate(want))   # ids in order
    agree, first = agreement(g, w)
    equal, compared = tie_rule(g, w, margins, max_new)
    return got == want, equal and compared >= n * max_new // 2, agree, first


def phase_sharded_streams(torch, card, cfg, params, prompts, mesh, dev="cuda"):
    """17a: bf16, the sharded engine (2 data shards of 2 slots) against the
    unsharded one over the bf16 and the NVFP4 pool. Held: every step of
    each shard bitwise the unsharded step over that shard's slice (a copy of
    its tree, its rows, its tables: what the reference runs on a shard),
    in the bf16 pool's greedy run; the teacher-forced sharded step at 0 bf16 ulps of
    the unsharded step over the bf16 pool (its GEMMs run
    `ops.bf16_matmul`, whose sums do not depend on the row count:
    tools/shard_step_diff.py found cuBLAS's at a prefill chunk's 64 rows
    against 32; over the NVFP4 pool the distance is reported); the served
    streams, greedy over both pools and sampled (temperature 0.8, top-k 8,
    the same base seed) over the bf16 pool, bitwise the unsharded engine's
    (the tie rule on the unsharded engine's decision margins,
    `decision_margins`, reported beside a failure). The sampler draws its noise per
    slot row and the sharded engine places requests by shard occupancy, so
    the unsharded engine gets the requests in the order of the sharded
    engine's slots: both then run one schedule in the same rows. Returns its
    numbers, the launches of its sharded runs and the sharded greedy
    bf16-pool streams with their margins (17d)."""
    from repro_torch.kernels import ops
    out, runs = {}, []
    for kv_quant in (False, True):
        ulps = sharded_step_ulps(torch, cfg, params, prompts, mesh, dev, kv_quant)
        pool = "NVFP4" if kv_quant else "bf16"
        log(f"  17a [{card}] bf16 teacher-forced, {pool} pool: the sharded "
            f"step's logits within {ulps:.3g} bf16 ulps of the unsharded "
            f"step's ({'reported' if kv_quant else 'held at 0'})")
        if not kv_quant and ulps != 0:
            fail(f"17a: the sharded step is {ulps} ulps from the unsharded step "
                 f"({pool} pool)")
        out[f"step_ulps_{pool}_pool"] = ulps
    for kv_quant, sampling in ((False, None), (True, None),
                               (False, SHARDED_SAMPLING)):
        label = (f"17a ({'NVFP4' if kv_quant else 'bf16'} pool, "
                 f"{'sampled' if sampling else 'greedy'})")
        eng = sharded_engine(cfg, params, dev, kv_quant=kv_quant, mesh=mesh)
        margins = decision_margins(torch, eng)
        counts = {"steps": 0}
        if not kv_quant and sampling is None:
            # once: the streams of all three runs are held bitwise against
            # the unsharded engine below
            checked_shard_steps(torch, eng, counts, label)
        ops.reset_launches()
        placed = []
        got = sharded_run(torch, eng, prompts, SHARDED_NEW, dev, label,
                          sampling, placed)
        launches = dict(ops.LAUNCHES)
        order = [i for i in placed if i is not None]
        ref = sharded_engine(cfg, params, dev, kv_quant=kv_quant)
        ref_margins = decision_margins(torch, ref)
        single = sharded_run(torch, ref, [prompts[i] for i in order],
                             SHARDED_NEW, dev, label, sampling)
        # back to submission order: request i went k-th into the reference
        single = [single[order.index(i)] for i in range(len(prompts))]
        ref_margins = {(order[rid], j): m
                       for (rid, j), m in ref_margins.items()}
        runs.append(launches)
        attn = "paged_gqa_q" if kv_quant else "paged_gqa"
        other = "paged_gqa" if kv_quant else "paged_gqa_q"
        if dev == "cuda" and (launches[attn] <= 0 or launches[other]):
            fail(f"{label}: the pool's attention kernel was not the one "
                 f"launched: {launches}")
        bitwise, met, agree, first = same_or_tie_rule(
            got, single, ref_margins, SHARDED_NEW, len(prompts))
        log(f"  {label} [{card}]: sharded streams "
            + ("bitwise the unsharded engine's" if bitwise else
               f"not bitwise, the tie rule {'met' if met else 'not met'} "
               f"({agree:.1%} of tokens before each row's first difference, "
               f"first by request {first})"))
        if dev == "cuda" and not bitwise:
            fail(f"{label}: the sharded bf16 streams are not the unsharded "
                 "engine's bit for bit")
        if counts["steps"]:
            log(f"  {label} [{card}]: {counts['steps']} steps, each shard's "
                "logits bitwise the unsharded step over its slice")
        out[label] = {"bitwise": bitwise, "tie_rule_met": met,
                      "agreement": agree, "first_diff": first,
                      "shard_steps_bitwise": counts["steps"],
                      "slot_order": placed, "launches": launches}
        if not kv_quant and sampling is None:
            base = (got, margins)
    return out, runs, base


def sharded_step_ulps(torch, cfg, params, prompts, mesh, dev, kv_quant):
    """17a's teacher-forced check: the bf16 sharded step against the
    unsharded step on the same slots, inputs and pool contents (a 16-token
    chunk, then one token; the 4 prompts' first 17 tokens), in bf16 ulps
    of each row's largest logit: held at 0 over the bf16 pool by the
    caller."""
    from repro_torch.serve import decode as serve_decode
    from repro_torch.serve.kv_pool import KVPool
    from repro_torch.serve.prequant import prequantize
    p = prequantize(params, cfg, "bf16")
    sharded = serve_decode.make_sharded_serve_step(cfg, "bf16", mesh)
    plain = serve_decode.make_paged_serve_step(cfg, "bf16")
    pools = [KVPool(cfg, 4, SHARDED_MAX_LEN, block_size=16, device=dev,
                    quantized=kv_quant, **kw)
             for kw in ({}, {"n_shards": 2, "devices": mesh.devices})]
    for pool in pools:
        for slot in range(4):
            pool.commit(slot, 17)
            pool.ensure(slot, 17)
    toks = torch.tensor([q[:17] for q in prompts], dtype=torch.int32)
    active = torch.ones(4, dtype=torch.bool)
    worst = 0.0
    for start, size in ((0, 16), (16, 1)):
        t, pos = toks[:, start:start + size], torch.full((4,), start,
                                                         dtype=torch.int32)
        want, _ = plain(p, pools[0].caches, pools[0].tables_device(), t.to(dev),
                        pos.to(dev), active.to(dev))
        got, _ = sharded([p, p], pools[1].shard_caches, pools[1].tables_device(),
                         t, pos, active)
        w, g = want[:, -1].float().cpu(), got[:, -1].float().cpu()
        for r in range(4):
            ulp = bf16_ulp(float(w[r].abs().max()))
            worst = max(worst, float((g[r] - w[r]).abs().max()) / ulp)
    return worst


def checked_shard_steps(torch, eng, counts, label):
    """Wrap `eng`'s sharded step: every call, each shard's logits against
    the unsharded step (`make_paged_serve_step`) run on a copy of that
    shard's cache tree with its rows of the inputs and its tables, what the
    reference's `shard_map` runs on a shard. Held bitwise; the checking
    steps' launches are taken back out of `ops.LAUNCHES` (comparisons, not
    the main path); `counts` gets a count of the steps checked."""
    from repro_torch.kernels import ops
    from repro_torch.serve import decode as serve_decode
    plain = serve_decode.make_paged_serve_step(eng.cfg, eng.econf.scheme)
    inner = eng._step

    def clone(tree):
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            vals = [clone(v) for v in tree]
            return type(tree)(*vals) if hasattr(tree, "_fields") else \
                type(tree)(vals)
        return tree.clone()

    def step(params, caches, tables, tokens, pos, active):
        n = tokens.shape[0] // len(caches)
        want, before = [], dict(ops.LAUNCHES)
        for s, dev in enumerate(eng.mesh.devices):
            r = slice(s * n, (s + 1) * n)
            want.append(plain(params[s], clone(caches[s]),
                              None if tables is None else tables[s],
                              tokens[r].to(dev), pos[r].to(dev),
                              active[r].to(dev))[0].to(eng.device))
        ops.LAUNCHES.update(before)
        logits, out = inner(params, caches, tables, tokens, pos, active)
        if not torch.equal(logits, torch.cat(want)):
            fail(f"{label}: a shard's step differs from the unsharded step "
                 "over its slice")
        counts["steps"] = counts.get("steps", 0) + 1
        return logits, out
    eng._step = step


def phase_sharded_quartet2(torch, card, cfg, params, prompts, mesh, dev="cuda"):
    """17b: quartet2 with prequant, sharded. Held: two runs bitwise each
    other; in the second every step of each shard bitwise the unsharded
    step over that shard's slice (each shard's activation absmax spans its
    own slots, the reference's semantics). Returns its numbers and the
    first run's launches."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    a = sharded_run(torch, sharded_engine(cfg, params, dev, scheme="quartet2",
                                          mesh=mesh),
                    prompts, SHARDED_NEW, dev, "17b")
    launches = dict(ops.LAUNCHES)
    if dev == "cuda" and any(launches[k] <= 0 for k in SERVING_KERNELS):
        fail(f"17b: a kernel of the path was not launched: {launches}")
    eng = sharded_engine(cfg, params, dev, scheme="quartet2", mesh=mesh)
    counts = {}
    checked_shard_steps(torch, eng, counts, "17b")
    b = sharded_run(torch, eng, prompts, SHARDED_NEW, dev, "17b")
    if a != b:
        fail(f"17b: two sharded quartet2 runs differ: "
             f"{agreement(dict(enumerate(a)), dict(enumerate(b)))[1]}")
    log(f"  17b [{card}] quartet2: two sharded runs bitwise; {counts['steps']} "
        "steps, each shard's logits bitwise the unsharded step over its slice")
    return {"bitwise_runs": True, "steps_checked": counts["steps"],
            "launches": launches}


def phase_sharded_prefix(torch, card, cfg, params, prompts, mesh, dev="cuda"):
    """17c: 2 slots (one a shard), the prefix cache with its host tier and
    replicate_hits 1, bf16. A prompt is cached from shard 0 and hit once;
    idle ticks copy its blocks into shard 1 (one a tick, free blocks only);
    a blocker takes shard 0 and the same prompt is placed on shard 1. Held:
    it admits hot there with no swap-in (the replicas), replicated blocks
    > 0, its stream bitwise the cold stream."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Request
    # 40 tokens: 2 blocks adopted and a third copied on write
    prompt = torch.randint(0, cfg.vocab, (40,),
                           generator=torch.Generator().manual_seed(173)).tolist()
    kw = dict(n_slots=2, mesh=mesh)
    cold = sharded_run(torch, sharded_engine(cfg, params, dev, **kw), [prompt],
                       SHARDED_NEW, dev, "17c cold")[0]
    ops.reset_launches()
    eng = sharded_engine(cfg, params, dev, prefix_cache=True, prefix_spill=True,
                         replicate_hits=1, **kw)
    for _ in range(2):    # cached from slot 0 (shard 0), then one hit there
        sharded_run(torch, eng, [prompt], SHARDED_NEW, dev, "17c")
    cs = eng.cache.stats
    for _ in range(2 * eng.pool.max_blocks):    # a block a tick
        before = cs["replicated_blocks"]
        eng.step()
        if cs["replicated_blocks"] == before:
            break
    replicated, swapped = cs["replicated_blocks"], cs["swapped_in_blocks"]
    skipped0 = eng.stats["prefill_skipped_tokens"]
    eng.submit(Request(list(prompt), 2 * SHARDED_NEW))      # the blocker
    shared = eng.submit(Request(list(prompt), SHARDED_NEW))
    eng.step()
    slot = next(i for i, s in enumerate(eng.slots)
                if s.req is not None and s.req.req_id == shared)
    res = {r.req_id: r.tokens for r in eng.run()}
    cuda_sync(torch, dev)
    launches = dict(ops.LAUNCHES)
    hot = eng.stats["prefill_skipped_tokens"] - skipped0
    ok = (replicated > 0 and eng.pool.shard_of_slot(slot) == 1
          and hot == 2 * (len(prompt) - 1)
          and cs["swapped_in_blocks"] == swapped and res[shared] == cold)
    log(f"  17c [{card}] prefix cache + host tier, replicate_hits 1: "
        f"{replicated} blocks replicated into shard 1; the request placed on "
        f"shard {eng.pool.shard_of_slot(slot)} skipped {hot // 2} of "
        f"{len(prompt)} prompt tokens with {cs['swapped_in_blocks'] - swapped} "
        f"swap-ins; stream {'bitwise' if res[shared] == cold else 'NOT equal to'}"
        " the cold one")
    if not ok:
        fail("17c: the replicated prefix did not admit hot on shard 1 bitwise cold")
    return {"replicated_blocks": replicated, "skipped_tokens": hot // 2,
            "bitwise": True, "launches": launches}


def phase_sharded_spec(torch, card, cfg, params, prompts, mesh, base, dev="cuda"):
    """17d: bf16, spec_k 3 over 2 draft layers, sharded (the draft pool
    sharded, its steps and its propose loop a shard at a time). Held: served
    whole, both pools conserved, speculative rounds run. Reported, as 9b
    reports the unsharded engine's: its streams against 17a's sharded
    non-speculative greedy streams, bitwise or by the tie rule (the verify
    runs 2 x 4 rows a shard where a step runs 2)."""
    from repro_torch.kernels import ops
    k, layers = SHARDED_SPEC
    layers = min(layers, cfg.n_layers - 1)   # the reduced rehearsal has 2
    ops.reset_launches()
    eng = sharded_engine(cfg, params, dev, mesh=mesh, spec_k=k,
                         draft_layers=layers)
    got = sharded_run(torch, eng, prompts, SHARDED_NEW, dev, "17d")
    launches = dict(ops.LAUNCHES)
    want, margins = base
    bitwise, met, agree, first = same_or_tie_rule(got, want, margins,
                                                  SHARDED_NEW, len(prompts))
    st = eng.stats
    log(f"  17d [{card}] bf16 spec_k {k} / {layers} draft layers, sharded: "
        f"{st['spec_rounds']} rounds, acceptance "
        f"{st['accepted_tokens'] / max(st['draft_tokens'], 1):.3f}; streams "
        "(reported) "
        + ("bitwise the sharded non-spec engine's" if bitwise else
           f"not bitwise, the tie rule {'met' if met else 'not met'} "
           f"({agree:.1%} of tokens before each row's first difference, first "
           f"by request {first})"))
    if st["spec_rounds"] <= 0:
        fail("17d: the sharded spec engine ran no speculative round")
    return {"bitwise": bitwise, "tie_rule_met": met, "agreement": agree,
            "rounds": st["spec_rounds"], "launches": launches}


def phase_sharded_kernels(torch, card):
    """17e: #5, #6, #7 and #8 on shard-local tables: a two-shard pool of 4
    slots (lengths 47, 100, 131 and an unbound slot whose row is all
    sentinel) gives each shard's (2, max_blocks) tables over local ids with
    the local sentinel blocks_per_shard, and each shard's leaves hold
    blocks_per_shard + 1 blocks, the last a scratch block of random bytes
    (no reader may see it). Each kernel against its plain version with the
    attention bar, inactive rows exactly 0."""
    from repro_torch.configs import registry
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.serve.kv_pool import KVPool
    pool = KVPool(registry.get("llama_200m").reduced(), 4, 256, block_size=16,
                  n_shards=2, device="cpu")
    for slot, n in zip(range(3), (47, 100, 131)):
        pool.commit(slot, n)
        pool.ensure(slot, n)
    bps = pool.blocks_per_shard
    errs = dict.fromkeys(("paged_gqa", "paged_gqa_q", "paged_mla",
                          "paged_mla_q"), 0.0)
    g = torch.Generator().manual_seed(171)
    for s, tables in enumerate(pool.tables_device()):
        table = tables[:, 0].contiguous().cuda()
        lens = [pool.length(i) for i in pool._shard_slots(s)]
        dead = tuple(j for j, n in enumerate(lens) if n == 0)
        if int(table.max()) != bps:
            fail("17e: a shard's table lacks its local sentinel")
        for sq in (1, 4):
            pos = torch.tensor([max(n - sq, 0) for n in lens],
                               dtype=torch.int32).cuda()
            q = torch.randn((2, sq, 10, 128), generator=g).bfloat16().cuda()
            k, v = ((torch.randn((bps + 1, 16, 10, 128), generator=g) * 3)
                    .bfloat16().cuda() for _ in range(2))
            label = f"shard {s}, Sq {sq}, {bps}+1 blocks"
            kr, vr = k[:bps], v[:bps]
            errs["paged_gqa"] = max(errs["paged_gqa"], check_against_plain(
                torch, "paged_gqa", ops.paged_gqa(q, kr, vr, table, pos),
                PA.paged_gqa_plain(q, kr, vr, table, pos), dead, label))
            kc, ks = F.nvfp4_cache_encode(k)
            vc, vs = F.nvfp4_cache_encode(v)
            args = (q, kc[:bps], ks[:bps], vc[:bps], vs[:bps], table, pos)
            errs["paged_gqa_q"] = max(errs["paged_gqa_q"], check_against_plain(
                torch, "paged_gqa_q", ops.paged_gqa_q(*args),
                PA.paged_gqa_q_plain(*args), dead, label))
            qa = (torch.randn((2, sq, 128, 512), generator=g) * 0.1).cuda()
            qr = torch.randn((2, sq, 128, 64), generator=g).bfloat16().cuda()
            cc = torch.randn((bps + 1, 16, 512), generator=g).bfloat16().cuda()
            kcr = (torch.randn((bps + 1, 16, 64), generator=g) * 2).bfloat16().cuda()
            args = (qa, qr, cc[:bps], kcr[:bps], table, pos)
            errs["paged_mla"] = max(errs["paged_mla"], check_against_plain(
                torch, "paged_mla", ops.paged_mla(*args, qk_dim=192),
                PA.paged_mla_plain(*args, 192), dead, label))
            (c1, c2), (k1, k2) = F.nvfp4_cache_encode(cc), F.nvfp4_cache_encode(kcr)
            args = (qa, qr, c1[:bps], c2[:bps], k1[:bps], k2[:bps], table, pos)
            errs["paged_mla_q"] = max(errs["paged_mla_q"], check_against_plain(
                torch, "paged_mla_q", ops.paged_mla_q(*args, qk_dim=192),
                PA.paged_mla_q_plain(*args, 192), dead, label))
    torch.cuda.synchronize()
    return errs, sharded_attn_groups(torch, errs)


SHARDED_STEP_LENS = (40, 28, 57, 45)  # 17e's timed step: 4 slots mid-decode


def sharded_attn_groups(torch, errs, dev="cuda"):
    """17e's timing: one full-batch decode step's #5 and #6 calls at phase
    17's shapes (4 layers, H = KV = 10, hd 128, blocks of 16, Sq 1, the
    slots at SHARDED_STEP_LENS), sharded (2 calls a layer over 2 rows, each
    shard's local tables and leaves) and unsharded (1 call a layer over 4
    rows), on the same K/V values: events and profiler ms, the plain
    version, SDPA over the gathered view, the bound. Held: each layer's two
    sharded outputs, stacked, within the attention bar of the unsharded
    output. Returns {kernel: {"sharded_step": ..., "unsharded_step": ...}}
    (dev="cpu" runs the plain versions and the check, no timing)."""
    from repro_torch.configs import registry
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.serve import kv_pool as KV
    cfg = registry.get("llama_200m").reduced()
    g = torch.Generator().manual_seed(172)
    maxb = SHARDED_MAX_LEN // 16
    # K and V by (slot, logical block): each pool places them by its table
    layers = [[(torch.randn((4, maxb, 16, 10, 128), generator=g) * 3).bfloat16()
               for _ in range(2)] for _ in range(SHARDED_LAYERS)]
    q_all = [torch.randn((4, 1, 10, 128), generator=g).bfloat16()
             for _ in range(SHARDED_LAYERS)]
    groups = {"paged_gqa": {}, "paged_gqa_q": {}}
    outs = {}
    for name, shards in (("sharded_step", 2), ("unsharded_step", 1)):
        pool = KV.KVPool(cfg, 4, SHARDED_MAX_LEN, block_size=16,
                         n_shards=shards, device="cpu")
        for slot, n in enumerate(SHARDED_STEP_LENS):
            pool.commit(slot, n + 1)
            pool.ensure(slot, n + 1)
        tables = (pool.tables_device() if shards > 1
                  else (pool.tables_device(),))
        bps = pool.blocks_per_shard
        local = pool._local_table_np()
        calls = []
        for (k0, v0), q in zip(layers, q_all):
            for s, t in enumerate(tables):
                rows = list(pool._shard_slots(s))
                kp, vp = (torch.zeros((bps, 16, 10, 128), dtype=torch.bfloat16)
                          for _ in range(2))
                for r in rows:
                    for j in range(maxb):
                        if local[r, j] < bps:
                            kp[local[r, j]], vp[local[r, j]] = k0[r, j], v0[r, j]
                pos = torch.tensor([SHARDED_STEP_LENS[r] for r in rows],
                                   dtype=torch.int32)
                calls.append([x.to(dev) for x in (q[rows], kp, vp,
                                                  t[:, 0].contiguous(), pos)])
        for packed, kname in ((False, "paged_gqa"), (True, "paged_gqa_q")):
            if packed:
                args = [(q, *F.nvfp4_cache_encode(kp), *F.nvfp4_cache_encode(vp),
                         tb, pos) for q, kp, vp, tb, pos in calls]
                views = [(q, KV.gather_view(KV.PackedKV(a[1], a[2]), tb),
                          KV.gather_view(KV.PackedKV(a[3], a[4]), tb), pos)
                         for a, (q, _, _, tb, pos) in zip(args, calls)]
                row_bytes = 10 * 256 * 0.5625
            else:
                args = calls
                views = [(q, KV.gather_view(kp, tb), KV.gather_view(vp, tb), pos)
                         for q, kp, vp, tb, pos in calls]
                row_bytes = None
            kern, plain = getattr(ops, kname), getattr(PA, f"{kname}_plain")
            fn = lambda kern=kern, args=args: [kern(*a) for a in args]
            got = fn()
            outs[(kname, name)] = [torch.cat(got[i:i + shards])
                                   for i in range(0, len(got), shards)]
            if dev != "cuda":
                continue
            sd = [gather_sdpa(torch, q, k, v, pos) for q, k, v, pos in views]
            sdpa_fn = lambda sd=sd: [f() for f in sd]
            nbytes, n_ops = map(sum, zip(*(attn_bytes_ops(
                c[0], c[1], c[2], c[3], c[4], kv_row_bytes=row_bytes)
                for c in calls)))
            r = dict(fn=fn, ms=time_ms(torch, fn, 20),
                     plain_ms=time_ms(torch, lambda plain=plain, args=args:
                                      [plain(*a) for a in args], 3),
                     library_ms=time_ms(torch, sdpa_fn, 20),
                     library_profiler_ms=device_ms(torch, sdpa_fn, ""),
                     bytes=nbytes, ops=n_ops, peak=F32_FLOPS, calls=len(args))
            log(f"  17e {kname}, one {name.replace('_', ' ')}:")
            finish_results({kname: r}, errs)
            groups[kname][name] = r
    for kname in groups:
        for a, b in zip(outs[(kname, "sharded_step")],
                        outs[(kname, "unsharded_step")]):
            if ((a - b).abs() > 5e-6 + 1e-5 * b.abs()).any():
                fail(f"17e: {kname}'s sharded calls differ from the unsharded "
                     "call past the attention bar")
    log("  17e the sharded step's #5 and #6 outputs, stacked, within the "
        "attention bar of the unsharded step's")
    return groups


def phase_sharded_readings(torch, card, cfg, params, prompts, mesh):
    """17f (readings, not claims): quartet2, the bf16 pool; the launches of
    #1, #2, #5 and #6 one full-batch decode step makes, unsharded against
    sharded (predicted: #1 and #2 twice, #5 one a layer a shard), and host
    ms, device ms and busy share a step of each (`profile_decode`)."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Request
    out = {}
    for name, kw in (("unsharded", {}), ("sharded", {"mesh": mesh})):
        eng = sharded_engine(cfg, params, "cuda", scheme="quartet2", **kw)
        fill_decode(eng, Request, prompts, 12)
        ops.reset_launches()
        eng.step()
        step = {k: v for k, v in ops.LAUNCHES.items() if v}
        eng.run()
        log(f"  17f [{card}] {name}: launches a full-batch decode step {step}")
        out[name] = {"launches_per_decode_step": step,
                     "profile": profile_decode(torch, eng, Request, prompts,
                                               SHARDED_PROFILE_STEPS)}
    return out


def phase_sharded_launch(torch, card):
    """`launch.serve --data-shards 2 --shard-devices cuda:0,cuda:0` (full
    llama-200m, quartet2, weights packed as drawn): 4 requests served over
    two shards on the one card, every block back on its shard."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    ops.reset_launches()
    out = launch_serve.main(["--arch", "llama_200m", "--data-shards", "2",
                             "--shard-devices", "cuda:0,cuda:0", "--batch", "4",
                             "--prompt-len", "16", "--tokens", "8"])
    launches = dict(ops.LAUNCHES)
    if (out["data_shards"] != 2 or out["requests"] != 4
            or out["free_by_shard"] != [out["n_blocks"] // 2] * 2
            or any(launches[k] <= 0 for k in SERVING_KERNELS)):
        fail(f"17: launch.serve --data-shards 2: {out}, launches {launches}")
    return {"decode_tok_s": out["decode_tok_s"], "launches": launches}


def phase_sharded(torch, card, llama_params, dev="cuda"):
    """Phase 17: mesh-sharded serving (17a-17f) of llama-200m's first
    SHARDED_LAYERS layers over `make_serve_mesh(2, 1, devices=[dev] * 2)`,
    both shards on the one card; then `launch.serve --data-shards 2`. Its
    sub-phases take dev="cpu" with reduced llama for a rehearsal of their
    logic (17e and 17f need the card). Returns its numbers ("launches": the
    sum over its main-path runs), 17e's kernel errors and its timed groups
    of #5 and #6."""
    from repro_torch.launch.mesh import make_serve_mesh
    t0 = time.perf_counter()
    if dev == "cuda":
        cfg, params = llama_cut(llama_params, SHARDED_LAYERS)
    else:
        cfg, params = llama_params
    mesh = make_serve_mesh(2, 1, devices=[dev, dev])
    log(f"phase 17: mesh-sharded serving (llama-200m at {cfg.n_layers} of "
        f"{10 if dev == 'cuda' else cfg.n_layers} layers; 2 data shards of 2 "
        f"slots on {', '.join(map(str, mesh.devices))})")
    prompts = sharded_prompts(torch, cfg.vocab)
    out, runs, base = phase_sharded_streams(torch, card, cfg, params, prompts,
                                            mesh, dev)
    out["quartet2"] = phase_sharded_quartet2(torch, card, cfg, params, prompts,
                                             mesh, dev)
    out["prefix"] = phase_sharded_prefix(torch, card, cfg, params, prompts,
                                         mesh, dev)
    out["spec"] = phase_sharded_spec(torch, card, cfg, params, prompts, mesh,
                                     base, dev)
    runs += [out[k]["launches"] for k in ("quartet2", "prefix", "spec")]
    errs, groups = {}, {}
    if dev == "cuda":
        errs, groups = phase_sharded_kernels(torch, card)
        out["readings"] = phase_sharded_readings(torch, card, cfg, params,
                                                 prompts, mesh)
        out["launch_serve"] = phase_sharded_launch(torch, card)
        runs.append(out["launch_serve"]["launches"])
    out["launches"] = {k: sum(r[k] for r in runs) for k in runs[0]}
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 17 took {out['phase_s']:.1f} s; launches on its main paths: "
        f"{out['launches']}")
    return out, errs, groups


# --------------------------------------------------------------------------
# phase 18: serving over a "model" axis
# --------------------------------------------------------------------------

# 18a: (scheme, kv_quant, prequant) of the (1, 2) runs, each against the
# unsharded engine's streams over its pool (the raw-weight run against the
# prequant run's: per-step quantization is prequant's, bitwise)
MODEL_RUNS = (("bf16", False, True), ("bf16", True, True),
              ("quartet2", False, True), ("quartet2", True, True),
              ("quartet2", False, False))
# 18c, predicted before the chip call: launches of one full-batch decode
# step over llama-200m's first 4 layers at (1, 2), both model ranks on the
# card. Each part of the 7 quantized linears of each layer quantizes the
# activation on its device (#1) and multiplies it by its N / 2 slice (#2);
# the step attends once a layer (#5) and each part computes its half of the
# bf16 head (bf16_matmul, 4 rows); raw weights add each part's 28 slice
# quantizations with the whole weight's absmax (#1, given absmax); under
# bf16 every linear is a bf16_matmul a part.
MODEL_STEP_LAUNCHES = {
    ("quartet2", True): {"nvfp4_fos_quant": 56, "fp4_matmul": 56,
                         "paged_gqa": 4, "bf16_matmul": 2},
    ("quartet2", False): {"nvfp4_fos_quant": 112, "fp4_matmul": 56,
                          "paged_gqa": 4, "bf16_matmul": 2},
    ("bf16", True): {"paged_gqa": 4, "bf16_matmul": 58},
}
MODEL_PROFILE_STEPS = 4   # 18d: full-batch decode steps timed, then profiled
BF16_MM_BAR = 1e-5        # bf16_matmul: * max|C_plain| (f32 summation order)


def model_fields_checked(torch, cfg, params, eng):
    """18b: every part of each split field byte for byte its model rank's
    slice of the whole prequantized tree's field (the whole matrix's
    gscale); each rank's resident packed bytes against the whole tree's.
    Returns (bytes by rank, whole bytes, split parts)."""
    from repro_torch.core.linear import ModelShard, PackedQWeight
    from repro_torch.dist.sharding import map_with_path, packed_bytes
    from repro_torch.serve.prequant import prequantize
    whole = prequantize(params, cfg, "quartet2")
    want = {}
    map_with_path(lambda p, x: want.__setitem__(p, x), whole,
                  is_leaf=lambda x: isinstance(x, PackedQWeight))
    split = 0
    tree = eng.shard_params[0]

    def one(path, leaf):
        nonlocal split
        if not isinstance(leaf, ModelShard):
            return
        ref = want[path]
        for rank, w in enumerate(leaf.parts):
            pairs = ([(w.packed, ref.packed), (w.scale_bits, ref.scale_bits)]
                     if isinstance(ref, PackedQWeight) else [(w, ref)])
            if isinstance(ref, PackedQWeight) and not torch.equal(
                    w.gscale, ref.gscale):
                fail(f"18b: {path}: rank {rank}'s gscale is not the whole's")
            for got, full in pairs:
                n = full.shape[-2] // 2
                if not torch.equal(got, full.narrow(full.dim() - 2, rank * n, n)):
                    fail(f"18b: {path}: rank {rank}'s field is not its slice")
            split += 1
    map_with_path(one, tree, is_leaf=lambda x: isinstance(
        x, (PackedQWeight, ModelShard)))
    by_rank = [packed_bytes(tree, j) for j in range(eng.mesh.model)]
    return by_rank, packed_bytes(whole), split


def phase_model_streams(torch, card, cfg, params, prompts, dev="cuda"):
    """18a-18c: the (1, 2) runs of MODEL_RUNS and one (2, 2) bf16 run, each
    held bitwise against the unsharded engine's streams; the split fields
    and resident bytes (18b); a full-batch decode step's launches against
    MODEL_STEP_LAUNCHES (18c). Returns its numbers, the runs' launches and
    the quartet2 prequant (1, 2) engine."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serve.engine import Request
    m12 = make_serve_mesh(1, 2, devices=[dev] * 2)
    out, runs, base, keep = {}, [], {}, None
    for scheme, kvq, pq in MODEL_RUNS + (("bf16", False, "2x2"),):
        if (scheme, kvq) not in base:
            base[(scheme, kvq)] = sharded_run(
                torch, sharded_engine(cfg, params, dev, scheme=scheme,
                                      kv_quant=kvq), prompts, SHARDED_NEW, dev,
                f"18a unsharded {scheme}")
        mesh = (make_serve_mesh(2, 2, devices=[dev] * 4) if pq == "2x2" else m12)
        label = (f"18a ({mesh.data}, {mesh.model}) {scheme}, "
                 f"{'NVFP4' if kvq else 'bf16'} pool, "
                 f"{'raw weights' if pq is False else 'prequant'}")
        ops.reset_launches()
        t0 = time.perf_counter()
        eng = sharded_engine(cfg, params, dev, scheme=scheme, kv_quant=kvq,
                             prequant=pq is not False, mesh=mesh)
        got = sharded_run(torch, eng, prompts, SHARDED_NEW, dev, label)
        wall = time.perf_counter() - t0
        runs.append(dict(ops.LAUNCHES))
        want = base[(scheme, kvq)]
        if got != want:
            fail(f"{label}: the streams are not the unsharded engine's bit for "
                 f"bit: {agreement(dict(enumerate(got)), dict(enumerate(want)))}")
        log(f"  {label} [{card}]: streams bitwise the unsharded engine's "
            f"({len(prompts)} requests x {SHARDED_NEW} tokens, {wall:.2f} s)")
        out[label] = {"bitwise": True, "wall_s": wall, "launches": runs[-1]}
        if (scheme, kvq, pq) == ("quartet2", False, True):
            keep = eng
        if pq in (True, False) and (scheme, pq) in MODEL_STEP_LAUNCHES \
                and not kvq and dev == "cuda":
            fill_decode(eng, Request, prompts, 12)   # the same engine, idle
            ops.reset_launches()
            eng.step()
            step = {k: v for k, v in ops.LAUNCHES.items() if v}
            eng.run()
            want = MODEL_STEP_LAUNCHES[(scheme, pq)]
            if step != want:
                fail(f"18c {scheme} {'prequant' if pq else 'raw'}: launches a "
                     f"decode step {step}, predicted {want}")
            log(f"  18c [{card}] {scheme} {'prequant' if pq else 'raw weights'}"
                f": launches a full-batch decode step {step}, as predicted")
            out[f"18c {scheme} {'prequant' if pq else 'raw'}"] = step
    by_rank, whole, split = model_fields_checked(torch, cfg, params, keep)
    log(f"  18b [{card}] {split} split fields (2 ranks) byte for byte the "
        f"slices of the whole packed tree's; resident packed bytes by model "
        f"device {by_rank} of {whole} unsplit ({by_rank[0] / whole:.4f})")
    if not all(abs(b - whole / 2) <= 0.001 * whole for b in by_rank):
        fail(f"18b: a model device holds {by_rank} of {whole} packed bytes, "
             "not half")
    out["packed_bytes_by_rank"], out["packed_bytes_whole"] = by_rank, whole
    return out, runs, keep


# bf16_matmul's rows of PERF.md's kernel table (18e; tools/bf16_mm_probe.py):
# (what, M, the (N, K) of its GEMMs). The bf16 scheme's GEMMs of one
# llama-200m step are 7 linears a layer over 10 layers and the head, on f32
# weights as the bf16 engine serves them.
LLAMA_STEP_NK = ([nk for _ in range(10) for nk in ARCH_SHAPES.values()]
                 + [(32000, 1280)])
BF16_MM_ROWS = {
    "9": ("a llama-200m bf16 decode step's 71 GEMMs", 4, LLAMA_STEP_NK),
    "9a": ("the same at a 16-token chunk of 4 slots", 64, LLAMA_STEP_NK),
    "9b": ("the same at a 16-token chunk of 8 slots", 128, LLAMA_STEP_NK),
    "9c": ("the same at a seed-loop prefill", 352, LLAMA_STEP_NK),
    "9d": ("llama-200m's head over a 16,384-token prompt (11d)", 16384,
           [(32000, 1280)]),
    "9e": ("nemotron-4-15b's head at a decode step", 4, [(256000, 6144)]),
}


def bf16_mm_calls(torch, g, m, shapes):
    """(a, w) pairs at M rows over `shapes` [(N, K)]: a bf16 activation,
    an f32 weight scaled to unit-variance outputs."""
    return [(torch.randn((m, k), generator=g, device="cuda").bfloat16(),
             torch.randn((n, k), generator=g, device="cuda") * k ** -0.5)
            for n, k in shapes]


def bf16_mm_row(torch, BM, ops, g, row, reps):
    """Row `row` of BF16_MM_ROWS: every call within BF16_MM_BAR of the plain
    version; on its first 8 calls, 4 of its rows (1 at M = 4: another
    activation width at M > 4) and each N / 2 half bitwise the whole
    call's; then timed (bf16_mm_group). Returns its group, with the max
    |dC| and the max of |dC| / max|C| over its calls."""
    what, m, shapes = BF16_MM_ROWS[row]
    calls = bf16_mm_calls(torch, g, m, shapes)
    err = rel = 0.0
    for i, (a, w) in enumerate(calls):
        got, want = ops.bf16_matmul(a, w), BM.bf16_matmul_plain(a, w)
        e, top = (got - want).abs().max().item(), want.abs().max().item()
        if not e <= BF16_MM_BAR * top:
            fail(f"18e bf16_matmul row {row} at {tuple(a.shape)} x "
                 f"{tuple(w.shape)}: {e} past {BF16_MM_BAR} * max|C|")
        err, rel = max(err, e), max(rel, e / top)
        del want
        if i < 8:
            h, n = (4 if m > 4 else 1), w.shape[0] // 2
            if not (torch.equal(ops.bf16_matmul(a[:h], w), got[:h])
                    and torch.equal(ops.bf16_matmul(a, w[:n]), got[:, :n])
                    and torch.equal(ops.bf16_matmul(a, w[n:]), got[:, n:])):
                fail(f"18e bf16_matmul row {row} at {tuple(a.shape)} x "
                     f"{tuple(w.shape)}: {h} of its rows or an N / 2 half is "
                     "not the whole call's, bit for bit")
        del got
    log(f"  row {row}, {what} (M = {m}; max |dC| {rel:.2e} of max|C|):")
    r = bf16_mm_group(torch, BM, ops, calls, reps)
    del calls
    torch.cuda.empty_cache()
    return {**r, "max_abs_err": err, "max_rel_err": rel}


def bf16_mm_group(torch, BM, ops, calls, reps):
    """bf16_matmul over `calls` [(a, w)]: events, profiler, plain and
    library (torch.matmul on the operands' bf16-exact f32 images, cast
    beforehand) times; the bound: a, w read once, C written once (f32),
    2 M N K operations at the card's bf16 rate (bf16 operands, f32
    accumulation, as the kernel runs them on the tensor cores)."""
    fn = lambda: [ops.bf16_matmul(a, w) for a, w in calls]
    r = {"calls": len(calls), "ms": time_ms(torch, fn, reps),
         "profiler_ms": device_ms(torch, fn, KERNEL_SYMBOLS["bf16_matmul"]),
         "plain_ms": time_ms(torch, lambda: [BM.bf16_matmul_plain(a, w)
                                             for a, w in calls], 3)}
    imgs = [(a.float(), w.bfloat16().float().T) for a, w in calls]
    lib_fn = lambda: [torch.matmul(a, w) for a, w in imgs]
    r["library_ms"] = time_ms(torch, lib_fn, reps)
    r["library_profiler_ms"] = device_ms(torch, lib_fn, "")
    del imgs, lib_fn
    nbytes = sum(a.numel() * a.element_size() + w.numel() * w.element_size()
                 + a.shape[0] * w.shape[0] * 4 for a, w in calls)
    n_ops = sum(2 * a.shape[0] * w.shape[0] * a.shape[1] for a, w in calls)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, n_ops / BF16_FLOPS * 1e3
    r.update(bytes=nbytes, ops=n_ops, bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations")
    log(f"  bf16_matmul {len(calls)} calls at M = {calls[0][0].shape[0]}: kernel "
        f"{r['ms']:.4f} ms (profiler {r['profiler_ms']}), plain "
        f"{r['plain_ms']:.4f} ms, torch.matmul {r['library_ms']:.4f} ms "
        f"(profiler {r['library_profiler_ms']}), bound {r['bound_ms']:.5f} ms "
        f"({r['bound_by']}: {nbytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} GFLOP)")
    return r


def phase_model_kernels(torch):
    """18e: the kernels of the model-axis path at its shapes. bf16_matmul
    (the port's own kernel) against its plain version over each row of
    BF16_MM_ROWS (llama-200m's 71 bf16 GEMMs at M = 4, 64, 128, 352, its
    head at 16,384 rows, nemotron-4-15b's head at 4), within BF16_MM_BAR of
    max|C|; on each row's first 8 calls a part of the rows and each N / 2
    half bitwise the whole call's (the card tests hold every plan); timed
    over each row; #2 over one llama-200m
    quartet2 decode step's 70 GEMMs whole and as the 2 x 70 N / 2 calls of
    its two model ranks (bitwise the whole's halves), timed; #1's
    given-absmax entry over the 2 x 70 weight halves a raw-weight step
    quantizes (bitwise the whole weight's quantization), timed. Returns
    (the bf16_matmul entry, its max error, groups by kernel)."""
    from repro_torch.kernels import bf16_matmul as BM
    from repro_torch.kernels import fp4_matmul as FM
    from repro_torch.kernels import nvfp4_quant as NQ
    from repro_torch.kernels import ops
    log("phase 18e: the model-axis path's kernels at llama-200m's shapes; "
        "bf16_matmul's rows 9-9e")
    g = torch.Generator(device="cuda").manual_seed(18)
    err, groups = 0.0, {"bf16_matmul": {}, "fp4_matmul": {},
                        "nvfp4_fos_quant": {}}
    for row in BF16_MM_ROWS:
        r = bf16_mm_row(torch, BM, ops, g, row,
                        20 if len(BF16_MM_ROWS[row][2]) > 1 else 10)
        groups["bf16_matmul"][f"row_{row}"] = r
        err = max(err, r["max_abs_err"])
    main = dict(groups["bf16_matmul"]["row_9"])
    torch.cuda.synchronize()
    # #2 whole and at N / 2, #1 given the whole weight's absmax
    acts = {k: ops.nvfp4_fos_quant(torch.randn((4, k), generator=g,
                                               device="cuda").bfloat16())
            for k in (1280, 3456)}
    weights = [torch.randn((n, k), generator=g, device="cuda") * k ** -0.5
               for _ in range(10) for n, k in ARCH_SHAPES.values()]
    whole = [ops.nvfp4_fos_quant(w) for w in weights]
    halves, quant_calls = [], []
    for w, q in zip(weights, whole):
        n = w.shape[0] // 2
        absmax = w.abs().amax().reshape(1)
        for j in range(2):
            part = w[j * n:(j + 1) * n].contiguous()
            hq = ops.nvfp4_fos_quant(part, absmax)
            if not (torch.equal(hq[0], q[0][j * n:(j + 1) * n])
                    and torch.equal(hq[1], q[1][j * n:(j + 1) * n])
                    and torch.equal(hq[2], q[2])):
                fail("18e: #1 given the whole weight's absmax is not the "
                     "whole weight's quantization of its half")
            halves.append(hq)
            quant_calls.append((part, absmax))
    mm_whole = [(acts[w[0].shape[1] * 2], w, torch.bfloat16) for w in whole]
    mm_half = [(acts[h[0].shape[1] * 2], h, torch.bfloat16) for h in halves]
    for i, (a, w, dt) in enumerate(mm_whole):
        full = ops.fp4_matmul(a[0], a[1], w[0], w[1], a[2], w[2], dt)
        parts = [ops.fp4_matmul(a[0], a[1], h[0], h[1], a[2], h[2], dt)
                 for _, h, _ in mm_half[2 * i:2 * i + 2]]
        if not torch.equal(torch.cat(parts, dim=1), full):
            fail("18e: #2 over the N / 2 halves is not the whole call's halves")
    log("  #2 over one llama-200m quartet2 decode step's 70 GEMMs (M = 4), whole:")
    groups["fp4_matmul"]["llama_decode_whole"] = matmul_group(
        torch, FM, ops, mm_whole, 20)
    log("  #2 over the same step at (1, 2): 2 x 70 calls on the N / 2 halves:")
    groups["fp4_matmul"]["llama_decode_half_N"] = matmul_group(
        torch, FM, ops, mm_half, 20)
    fn = lambda: [ops.nvfp4_fos_quant(x, am) for x, am in quant_calls]
    r = {"calls": len(quant_calls), "ms": time_ms(torch, fn, 10),
         "profiler_ms": device_ms(torch, fn, KERNEL_SYMBOLS["nvfp4_fos_quant"]),
         "plain_ms": time_ms(torch, lambda: [NQ.nvfp4_fos_quant_plain(x, am)
                                             for x, am in quant_calls], 1,
                             warmup=1),
         "library_ms": None, "library_profiler_ms": None}
    nbytes = sum(x.numel() * (x.element_size() + 0.5 + 1 / 16) + 8
                 for x, _ in quant_calls)
    n_ops = sum(x.numel() for x, _ in quant_calls) * QUANT_FLOPS_PER_ELEMENT
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, n_ops / F32_FLOPS * 1e3
    r.update(bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations")
    log(f"  #1 given absmax, {len(quant_calls)} weight halves of a raw-weight "
        f"step: kernel {r['ms']:.4f} ms (profiler {r['profiler_ms']}), plain "
        f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.5f} ms "
        f"({r['bound_by']}: {nbytes / 1e6:.1f} MB)")
    groups["nvfp4_fos_quant"]["given_absmax_half_N"] = r
    del weights, whole, halves, quant_calls, mm_whole, mm_half
    torch.cuda.empty_cache()
    return main, err, groups


def phase_model_launch(torch, card):
    """`launch.serve --model-shards 2 --shard-devices cuda:0,cuda:0` (full
    llama-200m, quartet2, weights packed as drawn): 4 requests served,
    every block free, each model device holding half the packed bytes."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    ops.reset_launches()
    out = launch_serve.main(["--arch", "llama_200m", "--model-shards", "2",
                             "--shard-devices", "cuda:0,cuda:0", "--batch", "4",
                             "--prompt-len", "16", "--tokens", "8"])
    launches = dict(ops.LAUNCHES)
    (a, b), = out["packed_bytes"]
    if (out["model_shards"] != 2 or out["requests"] != 4
            or out["free_blocks"] != out["n_blocks"]
            or abs(a - out["packed_bytes_whole"] / 2) > 1e-3 * a or a != b
            or any(launches[k] <= 0 for k in SERVING_KERNELS)):
        fail(f"18: launch.serve --model-shards 2: {out}, launches {launches}")
    log(f"  18 [{card}] launch.serve --model-shards 2: decode "
        f"{out['decode_tok_s']:.1f} tok/s, packed bytes by model device "
        f"{[a, b]} of {out['packed_bytes_whole']}")
    return {"decode_tok_s": out["decode_tok_s"], "launches": launches,
            "packed_bytes": [a, b], "packed_bytes_whole": out["packed_bytes_whole"]}


def phase_model(torch, card, llama_params, dev="cuda", unsharded=None):
    """Phase 18: serving over a "model" axis (18a-18e) of llama-200m's first
    SHARDED_LAYERS layers, both model devices (and at (2, 2) all four) on
    the one card; then `launch.serve --model-shards 2`. dev="cpu" with
    reduced llama rehearses 18a-18c (18d and 18e need the card). Returns
    its numbers ("launches": the sum over its main-path runs), bf16_matmul's
    entry and error, and the kernels' groups. `unsharded`: phase 17f's
    reading of the same unsharded quartet2 engine (18d profiles it only
    when it is not given)."""
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serve.engine import Request
    t0 = time.perf_counter()
    if dev == "cuda":
        cfg, params = llama_cut(llama_params, SHARDED_LAYERS)
    else:
        cfg, params = llama_params
    log(f"phase 18: serving over a 'model' axis (llama-200m at {cfg.n_layers} "
        f"layers; make_serve_mesh(1, 2) and (2, 2), the devices on {dev})")
    prompts = sharded_prompts(torch, cfg.vocab)
    out, runs, eng = phase_model_streams(torch, card, cfg, params, prompts, dev)
    bf16_mm, err, groups = None, 0.0, {}
    if dev == "cuda":
        del eng
        readings = {"unsharded": unsharded} if unsharded else {}
        for name, kw in (("unsharded", {}), ("model_2", {
                "mesh": make_serve_mesh(1, 2, devices=[dev] * 2)})):
            if name in readings:
                continue
            e = sharded_engine(cfg, params, dev, scheme="quartet2", **kw)
            log(f"  18d [{card}] {name}, quartet2:")
            readings[name] = profile_decode(torch, e, Request, prompts,
                                            MODEL_PROFILE_STEPS)
            del e
        out["readings"] = readings
        bf16_mm, err, groups = phase_model_kernels(torch)
        out["launch_serve"] = phase_model_launch(torch, card)
        runs.append(out["launch_serve"]["launches"])
    out["launches"] = {k: sum(r.get(k, 0) for r in runs) for k in runs[0]}
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 18 took {out['phase_s']:.1f} s; launches on its main paths: "
        f"{out['launches']}")
    return out, bf16_mm, err, groups


def ns_gemm_flops(shape) -> float:
    """The f32 GEMM operations of one `newton_schulz` call on a (..., r, c)
    stack: per iteration X X^T, S S and (.) X at n = min(r, c), m = max."""
    *lead, r, c = shape
    n, m = min(r, c), max(r, c)
    batch = 1
    for x in lead:
        batch *= x
    return batch * 5 * (2 * n * n * m + 2 * n ** 3 + 2 * n * n * m)


def ptxas_summary(build_log: str, prefix: str):
    """One line per kernel whose mangled name holds `prefix`: its registers,
    stack, spills and static shared memory, as `nvcc -Xptxas -v` reports."""
    out, name, frame = [], None, ""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = mangled if prefix in mangled else None
        elif name and "stack frame" in line:
            frame = line.strip()
        elif name and "Used" in line and "registers" in line:
            short = name[name.rindex(prefix):]
            out.append(f"{short[:60]}: {line.split(':', 1)[1].strip()}; {frame}")
            name = None
    return out


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")

    log("phase 1: device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    name = torch.cuda.get_device_name(0)
    log(f"  {name} (torch {torch.__version__}, CUDA {torch.version.cuda}); {card}")

    # the reduced CPU runs of phases 8, 9 and 12 run beside the card's work
    start_cpu_references()
    log("phase 2: build")
    t0 = time.perf_counter()
    build.library()
    log(f"  built {build.BUILD_INFO['path']} in {time.perf_counter() - t0:.1f} s")
    spills = [ln.strip() for ln in build.BUILD_INFO.get("log", "").splitlines()
              if "spill" in ln and " 0 bytes spill stores" not in ln]
    if spills:
        log("  ptxas reports spills: " + "; ".join(spills))
    for prefix in ("nvfp4_fos_quant_", "ms_eden_phase1_", "ms_eden_phase2_", "fp4_matmul_",
                   "paged_gqa_", "paged_mla_", "bf16_matmul_"):
        for line in ptxas_summary(build.BUILD_INFO.get("log", ""), prefix):
            log("  ptxas " + line)

    kern = phase_kernels(torch)
    requant, mm_err = phase_requant(torch)
    kern.update(requant)
    kern["fp4_matmul"]["max_abs_err"] = max(kern["fp4_matmul"]["max_abs_err"], mm_err)
    kern.update(phase_paged_q_mla(torch))
    for k, err in phase_gqa_splits(torch).items():
        kern[k]["max_abs_err"] = max(kern[k]["max_abs_err"], err)
    kern["fp4_matmul"]["groups"] = phase_matmul_groups(torch)
    phase_small_reference(torch)
    phase_train_reference(torch)
    llama = llama_weights(torch)
    serving = phase_serving(torch, card, llama)
    serving_kvq = phase_serving(torch, card, llama, kv_quant=True)
    # phase 8 serves these weights again; they wait in host memory through
    # phases 6, 5 and 7 (and deepseek-v3's from its end), whose weight bytes
    # and peak device memory then count their own model alone
    held_llama = to_device(llama, "cpu")
    del llama
    torch.cuda.empty_cache()
    deepseek, ds_cfg, ds_params = phase_deepseek(torch, card)
    held = (held_llama, to_device(ds_params, "cpu"))
    del held_llama, ds_params
    torch.cuda.empty_cache()
    training = phase_training(torch, card)
    resume = phase_resume(torch, card)
    nanochat = phase_nanochat(torch, card)
    llama, ds_params = to_device(held, "cuda")
    del held
    prefix = phase_prefix(torch, card, llama, ds_cfg, ds_params)
    spec, spec_errs = phase_spec(torch, card, llama, ds_cfg, ds_params, deepseek)
    for k, err in spec_errs.items():
        kern[k]["max_abs_err"] = max(kern[k]["max_abs_err"], err)
    http, http_errs = phase_http(torch, card, llama, serving["prompts"])
    for k, err in http_errs.items():
        kern[k]["max_abs_err"] = max(kern[k]["max_abs_err"], err)
    disagg = phase_disagg(torch, card, llama)
    sharded, sharded_errs, sharded_groups = phase_sharded(torch, card, llama)
    for k, err in sharded_errs.items():
        kern[k]["max_abs_err"] = max(kern[k]["max_abs_err"], err)
    for k, grps in sharded_groups.items():
        kern[k].setdefault("groups", {}).update(grps)
    model, bf16_mm, bf16_err, model_groups = phase_model(
        torch, card, llama, unsharded=sharded["readings"]["unsharded"]["profile"])
    kern["bf16_matmul"] = {**bf16_mm, "max_abs_err": bf16_err}
    for k, grps in model_groups.items():
        kern[k].setdefault("groups", {}).update(grps)
    t_gen = time.perf_counter()
    generate, gen_errs = phase_generate_llama(torch, card, llama,
                                              serving["prompts"],
                                              serving["streams"])
    generate["deepseek"] = phase_generate_deepseek(
        torch, card, ds_cfg, ds_params, deepseek["bf16_pool"]["streams"])
    del ds_params
    torch.cuda.empty_cache()
    generate["long"], long_errs = phase_generate_long(torch, card, llama)
    del llama
    torch.cuda.empty_cache()
    for errs in (gen_errs, long_errs):
        for k, err in errs.items():
            kern[k]["max_abs_err"] = max(kern[k]["max_abs_err"], err)
    m = generate["quartet2"]["prefill_m"]
    for k, grp in generate["quartet2"]["kernel_groups"].items():
        kern[k].setdefault("groups", {})[f"prefill_M{m}"] = grp
    generate["phase_s"] = time.perf_counter() - t_gen
    log(f"  phase 11 took {generate['phase_s']:.1f} s")
    registry_out, reg_groups, reg_errs = phase_registry(torch, card)
    for k, err in reg_errs.items():
        kern[k]["max_abs_err"] = max(kern[k]["max_abs_err"], err)
    for k, grps in reg_groups.items():
        kern[k].setdefault("groups", {}).update(grps)
    recurrent_out, rec_groups, rec_errs = phase_recurrent(torch, card)
    whisper_out, wh_groups, wh_errs = phase_whisper(torch, card)
    for errs in (rec_errs, wh_errs):
        for k, err in errs.items():
            kern[k]["max_abs_err"] = max(kern[k]["max_abs_err"], err)
    for grps_of in (rec_groups, wh_groups):
        for k, grps in grps_of.items():
            kern[k].setdefault("groups", {}).update(grps)
    dp, dp_errs = phase_dp(torch, card)
    for k, err in dp_errs.items():
        kern[k]["max_abs_err"] = max(kern[k]["max_abs_err"], err)
    path_runs = (serving, serving_kvq, deepseek["bf16_pool"],
                 deepseek["nvfp4_pool"], training, resume, nanochat, prefix, spec,
                 http, generate["quartet2"], generate["deepseek"], generate["long"],
                 registry_out, recurrent_out, whisper_out, disagg, dp, sharded,
                 model)

    kernels = []
    for k, r in kern.items():
        # launches: the sum over the main-path runs (each path is driven with
        # the counts set to 0 just before it and read just after)
        launches = sum(run["launches"].get(k, 0) for run in path_runs)
        if launches <= 0:
            fail(f"kernel {k} was not launched on a main path")
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "profiler_ms": r["profiler_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **({"library_profiler_ms": r["library_profiler_ms"]}
               if "library_profiler_ms" in r else {}),
            **({"groups": {gname: {key: grp[key] for key in (
                "calls", "ms", "profiler_ms", "plain_ms", "library_ms",
                "library_profiler_ms", "bound_ms", "bound_by")}
                for gname, grp in r["groups"].items()}}
               if "groups" in r else {})})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "device": name, "torch": torch.__version__,
         "build_s": build.BUILD_INFO.get("seconds"), "kernels": kernels,
         "kernel_detail": kern, "serving": serving, "serving_kv_quant": serving_kvq,
         "deepseek": deepseek, "training": training, "resume": resume,
         "nanochat": nanochat, "prefix": prefix, "spec": spec, "http": http,
         "generate": generate, "registry": registry_out,
         "recurrent": recurrent_out, "whisper": whisper_out, "disagg": disagg,
         "dp": dp, "sharded": sharded, "model": model},
        indent=1, default=str))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
