"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code if it fails:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: the seven CUDA kernels compiled with nvcc for sm_90a from the
   sources in the checkout (into build/kernels/), all at once; then the
   logmem phase rule's premise on the card: torch.log2 of 2^p floors to
   p for p = 0..30;
3. parity: each kernel against its plain PyTorch version on the card at
   its paths' shapes (1,000,000 streams; 64 and 4096 logmem tenants x
   8192; one stream of 2^20 and 2^26 scores; plan_solve at the inputs of
   the 1,000,000-stream plan's launches and of a 4-tier constrained
   fleet's, in float32 and float64, through both of its kernels) and
   edge cases (for batched_topk NaN scores and bars and signed zeros,
   for tier_assign ids at the boundaries and at INT32_MAX - 1 and floors
   of T - 1, for logmem_update grids of 1, 131, 133 and 1,025 streams,
   rows of 512, 513 and 36, NaN scores and thresholds, signed zeros and
   all-pad tiles, for topk_filter partial tiles, N % 4 != 0 and NaN,
   all four also from a base 4 bytes off 16-byte alignment, each
   logging the kernel its launch_plan picks; for
   plan_solve also ties at
   G=5456, a NaN in a last subset's last tuple alone, and a NaN-skipped
   first subset before infeasible ones, which must give (+inf, 0); and
   at the online re-solve's four-tier shape (4,096 streams of phase
   13b's fleet, float64, masked, terms with +inf) as it comes, with
   every tuple of some streams +inf, which must give (+inf, 0), and
   behind an all-+inf subset, whose streams must take the second);
   exact (NaN where the plain version has NaN), and batched_topk,
   logmem_update and topk_filter also bit for bit, among them tiles whose
   maximum is +0.0 or -0.0; then
   flash_attention and entropy_scores at the score producers' shapes
   (head dims 64 and 128; hymba-1.5b's 25 query heads over 5 KV heads
   under its 1024-token window, and a ragged odd group; grok-1-314b's
   48 heads over 8 with its logits soft-capped at 30, and caps of 5
   and 2 that bite, the capped row log-sum-exp checked too;
   vocabularies of 128,256, 131,072, 49,152, 50,280 and 32,001, the
   last on the scalar path) and edge cases, among them a 4096-key
   sliding window over 4608 keys at head dim 128 (see below) and 2200
   keys under a window of 1500 at a cap of 5, which are also held to the
   model's chunked_attention (the reference's scan over key chunks); then
   flash_attention's backward (its dQ and
   dK/dV launches and, where ops.backward_plan splits the query-head
   group over dK/dV blocks, the group sum) and the forward's row
   log-sum-exp against reference_backward and reference_lse at the same
   cases and at the seams (groups of 1, 4 and 12, head dims 16-128,
   Sq and Skv off multiples of 64, batch 1, windows, Sq > Skv with rows
   whose keys are all masked; groups split whole, in parts and not at
   all, as the plan says, among them unsplit sums over 8 heads of 4096
   queries and 6 of 2048): float32 within 1e-4 of each plain gradient's
   largest magnitude, bfloat16 within 2e-2, and a second call bit-equal
   to the first; the backward of a capped forward (FA_CASES' capped
   cases and FA_BWD_CAPPED: caps of 30, 5 and 2, head dims 16 to 128)
   and at MLA's head dims (FA_BWD_MLA: (192, 128) at deepseek-v2's
   training launch of 8 x 1024 x 128 heads, ragged, with rows with no
   key and a window; (24, 16) grouped, split and non-causal) under the
   same limits, with the kernel route's and the float32 plain route's
   distances from the float64 plain route beside (there and at
   llama3.2-1b's and whisper-base's encoder and cross launches, the
   kernel route's at most 3 times the plain route's on dq, dk and dv),
   and the key-bias residue (the sum of dk over the keys, whose exact
   value is 0 uncapped) of both;
   flash_attention at MLA's unequal head dims (q/k
   192, v 128; deepseek-v2-236b's prefill of 8 x 1024 at 128 heads, a
   ragged Sq < Skv case, rows with no key, and the reduced config's 24
   and 16) with its log-sum-exp, and past one latent chunk (1,300 keys)
   against the model's _mla_attend_latent_chunked on the same latents;
   flash_attention non-causal with no window, forward with its
   log-sum-exp and backward, at whisper-base's encoder (8 x 1500 x 1500,
   8 heads of 64) and cross-attention (8 x 416 and 8 x 448 queries over
   1500 frames) launches and at batch 2, a ragged Sq = Skv = 1500 over a
   group of 2 and Sq > Skv (90 x 33); whisper-base's causal decoder
   self-attention (8 x 416 and 8 x 448, a group of 1) and pixtral-12b's
   causal prefill (8 x 2048, 32 heads over 8 of 128), and phase 25's
   causal prefills (8 x 1024 at head dim 128: yi-9b's 32 heads over 4,
   command-r-plus-104b's 96 over 8); entropy_scores at whisper-base's
   vocabulary of 51,865 (scalar loads) and at yi-9b's 64,000 and
   command-r-plus-104b's 256,000;
4. timings: each kernel, its plain version and its bound (bytes, or
   operations where they take longer), with the PyTorch call that
   computes the same function where there is one; flash_attention and
   entropy_scores at the score producers' shapes (hymba-1.5b's windowed
   prefill beside SDPA with the boolean window mask; grok-1-314b's
   capped prefill beside the same launch uncapped, flex_attention with
   a tanh score_mod (compiled; held once to the plain version) and SDPA
   uncapped, and the uncapped launches at the other three shapes held
   within the spread PERF.md records for them plus 5% on a 700 W card;
   deepseek-v2-236b's MLA prefill at head dims 192 and 128 beside SDPA
   with is_causal and the same scale, its backend named; whisper-base's
   encoder and cross-attention launches, forward and backward, every
   pair visible, pixtral-12b's prefill and phase 25's two, each beside
   SDPA with the same mask and enable_gqa; entropy_scores at phase 25's
   vocabularies beside cross_entropy),
   batched_topk and tier_assign at the main path's, logmem_update and
   topk_filter at their paths' shapes and a large one, and each
   plan_solve launch (with the kernel and launch plan it took; the
   re-solve's among them), each the median of 5 profiled windows with
   its spread; logmem_update at 64 x 8192, topk_filter at 2^20 and
   entropy_scores at 8 x 128,256, whose inputs stay in the
   card's L2 between back-to-back calls, also L2-cold (128 MiB written
   before each call); flash_attention's backward at both serve shapes,
   every launch of a call, with its 5-product bound and SDPA's backward
   (forward plus backward less its forward), which it must beat, and at
   phase 22's full-width launches (grok-1-314b's capped at 30 beside
   flex_attention's backward; deepseek-v2-236b's at (192, 128) beside
   SDPA's), each with its launches' registers, shared memory and blocks
   an SM; and the
   forward with the log-sum-exp written beside without it, in turns (it
   must cost no more, within the spread);
5. main path at full width — the defaults of examples/million_streams.py:
   1,000,000 streams, 3 tiers, K=8, planned on the card by the device
   planner (shp.plan_ntier_arrays, plan_solve), the shared hot-tier
   budget water-filled and the binding streams re-solved under their
   grants, both solves held to the NumPy oracle; then 256 docs per
   stream ingested with ingest_chunks in 16 chunks of 16, meter off, and
   finalize_tiers; launch counters, per-tier counts and 256 sampled
   streams against core.simulator replays;
6. metered self-check: examples_torch/multi_tenant_streams.py's run() at
   its defaults (1024 tenants, the fleet, shuffled ingest and replay
   check of examples/multi_tenant_streams.py), then on the engine it
   returns survivors against simulator replays and finalize_tiers
   against the meter's attribution; its own launch counters must show
   both kernels on this path too;
7. a torch.profiler profile of full-width steps: the compute engine's
   busy share and that of any engine (compute or copy);
8. mixed fleet at full width — examples/million_streams.py
   --logmem-streams 64 on one card: phase 5's plan for the 1,000,000
   exact streams plus 64 logmem tenants at K=65536 (r = 4K), 16 chunks
   of (1,000,000 x 16) and (64 x 8192) through ingest_chunks, meter off,
   then finalize_tiers; the example's law and memory checks, launch
   counters, 256 sampled exact streams against simulator replays, and
   every logmem state leaf and chunk write mask against the port's own
   CPU run of the same chunks; docs/s beside phase 5's, and a profile of
   mixed steps as in phase 7;
9. huge-K harness: logmem.trace_competitive_ratio at the reference's
   RATIO_SWEEP (benchmarks/streams_bench.py) on the card, held to the
   1 - c/sqrt(K) guarantee and to the port's CPU run;
10. single-stream path: filter_then_merge at K=1024 over 64 batches of
   2^20 scores, survivors against numpy's top-1024 of the whole trace;
   then torch.profiler windows of 12 cold batches: the topk_filter
   kernel's device time inside its caller, the step's other device
   operations and the device's busy share;
11. the score producer at full width: llama3.2-1b (16 layers, d_model
   2048, 32 heads over 8 KV heads, vocab 128,256, float32) with weights
   from a seeded torch.Generator on the card, serving 64 requests in
   batches of 8 (prompts of 1024 tokens, 32 generated) through
   launch.serve.serve, once retained by the single-tenant curator and
   TieredStore and once by the 8-tenant StreamEngine; flash_attention
   runs every prefill layer (16 launches a batch) and entropy_scores
   every scored decode step (31 a batch); the first batch teacher-forced
   through the kernel route and the plain route (grouped attention,
   -sum p log p) on the card; retained sets against the top-K of the
   scores and simulator replays; profiles of a prefill and of decode
   steps;
12. starcoder2-3b at full width (30 layers, d_model 3072, 24 heads over
   2 KV heads, head_dim 128, d_ff 12288, GELU, LayerNorm and biases,
   vocab 49,152, window 4096, float32; seeded random weights on the
   card): the first batch teacher-forced through both routes, then 16
   requests in 2 batches of 8 (prompts of 1024, 32 generated, top-8
   retained) with exactly 60 flash_attention and 62 entropy_scores
   launches; profiles of a prefill and of decode steps;
13. drift-aware re-planning at fleet scale: examples/online_replanning.py's
   setting (K=64, windows of 12,000 docs, an 8x record-rate burst at doc
   3,000, chunks of 64, DriftConfig(alpha=0.05)) through
   StreamEngine(replan=) on the card, meter on: 13a 16,384 two-tier
   tenants of the example's make_fleet shape (costs jittered, hot tier
   of 4K docs), 13b 4,096 four-tier tenants drawn as
   tests/test_constraints.py draws its N-tier models, with K/2 caps on
   tiers 1 and 3 (the re-solve's four-tier subsets take plan_solve's
   masked route with +inf terms); chunks made one at a time from a
   seeded generator (3.9e8 + 4.9e7 docs), then finalize_tiers. Logged
   and checked: launches of batched_topk, tier_assign and plan_solve
   (plan_solve > 0 inside 13b's re-plans), replan / applied / feasible /
   admission counts, the re-plan hook's host seconds; 512 sampled
   streams of each engine against the port's CPU run of the same chunks
   (started from the card's planned boundaries, the re-solve pinned to
   the device route): replan and admission events, drift leaves,
   boundaries, survivors and tiers equal, suffix costs within 1e-11;
   tests/test_online.py:387's acceptance on 16 sampled 13a streams
   (re-planned < static, <= 1.10 x the process oracle) and 13a's
   check_constraints; docs/s with replan= beside the same fleet without
   it; a torch.profiler window of 13b's largest re-planning chunk (host
   and device ms) and its plan_solve launches timed alone (median of 5
   windows) beside their plain version and bound;
14. fleet observability (repro_torch.obs) on the card. 14a: phase 5's
   1,000,000 streams (its plan, 16 chunks of 16, meter off) with
   Observability(ObsConfig(costs=True)) beside the same engine without
   obs over the same chunks: survivors and tiers bit-equal, the
   synchronizing CUDA operations of the 16 steps equal with obs on and
   off (torch.cuda.set_sync_debug_mode("warn")), metrics.snapshot one
   drain; DOCS = 2.56e8, ADMITS - EVICTIONS = the live reservoir slots,
   each stream's ledger writes = its write-mask total; 256 sampled
   streams' ledger rows and reservoir rows against the port's CPU run
   and their packed counters on the card against the CPU; docs/s with
   and without obs beside phase 5's, and the step's device time with
   and without obs (torch.profiler). 14b: examples/cost_attribution.py's
   setting (K=64, windows of 12,000 docs, the first half of the tenants
   with an 8x burst at doc 3,000, chunks of 64, TierCapacity(0, 4K),
   ObsConfig(costs=True, cost_trigger=True, cost_alpha=0.01,
   budget_factor=1.2), DriftConfig(alpha=1e-9)) at 8,192 tenants,
   meter on, chunks made one at a time from a seeded generator: the
   chain (cost or burn alerts on drifted tenants, cost-triggered
   re-plans applied, the drifted tenants' realized-cost slope lower
   after their median first re-plan), two chunks through ingest() under
   torch.profiler with profiler_annotations (the "ingest" and "replan"
   ranges), /metrics on 127.0.0.1 scraped before and after them (typed
   counters that do not fall), Observability.write's three artifacts,
   512 sampled tenants against the port's CPU run and a card engine of
   the same tenants (events in order, alerts, re-plan events, ledger
   rows and cost_summary bit for bit, drift_score_max within 1 ulp);
   docs/s beside the same fleet without obs=, the monitors' host ms a
   chunk, and the events per kind;
15. resilience (repro_torch.resilience) on the card. 15a: phase 8's
   mixed fleet (phase 5's plan for 1,000,000 exact streams plus 64
   logmem tenants at K=65,536), 16 chunks, meter on, through
   ingest_with_faults over a FaultyChunkSource (transients, duplicates,
   reordering, NaN lacing; no sleeps), beside run_with_recovery over the
   same source with a device loss at chunk 9 and FleetCheckpointer(every=
   4) (async), the engine rebuilt on the card: every state leaf,
   assign_tiers' tiers and counts and every meter ledger bit-equal;
   restarts and the harness's stats, the checkpoint's bytes, each save's
   host ms, the write + sha256 ms on the worker, the restore ms; a torn
   .tmp save ignored and a flipped byte refused; docs/s of ingest_chunks
   (meter off) with every=4 beside no checkpointer, in turns. 15b:
   examples/chaos_recovery.py at 4,096 tenants (three tiers, half planned
   on the card and half pinned to (32, 0.8 N), K=8, W=32, 12 + 6 chunks,
   re-planning and cost attribution on): a child process (this script
   with --chaos-child) checkpoints every 2 chunks and SIGKILLs itself
   after chunk 7; the parent restores onto a fresh card engine, replays,
   and the sha256 of the survivors and every ledger equals the
   uninterrupted run's; then TierOutage(tier=1, burn_grace=8,
   hysteresis=2) under load: rows evacuated, skipped and infeasible,
   moved docs, the bill, the evacuation's host seconds, the outage
   events, zero budget-burn false fires, regret_table; 512 sampled
   tenants against the port's CPU run of the same chunks and outage
   (evacuated rows, moved docs, bills, re-plan events, ledger rows bit
   for bit). 15c: python -m repro_torch.launch.serve --device cuda
   --tenants 8 --requests 64 --batch 8 --ckpt-dir --ckpt-every 1
   --obs-out --obs-hold 60 (reduced llama3.2-1b), a child of the
   launcher batch (below; it runs beside phase 3), SIGTERM after its
   first checkpoint: exit 0, both shutdown lines, metrics.json, and the
   final checkpoint restores with the printed cursor. The checkpoints
   are written under build/ and removed;
16. fleet-axis sharding (repro_torch.parallel.fleet) at full width on a
   FleetMesh of 8 shards on cuda:0 (examples/million_streams.py's
   --devices 8; one card, so the shards share it). 16a: phase 5's plan
   with the mesh active (plan_solve launched per shard: 8x phase 5's
   launches), totals, bounds and migrate flags bit-equal to phase 5's;
   planner.waterfill(mesh=) (waterfill_sharded: a float64 bisection,
   per-shard sums added on shard 0) within 1e-7 of
   constraints.waterfill_grants and never over the budget; the re-solve
   of phase 5's binding streams under their grants bit-equal to phase
   5's. 16b: phase 8's mixed fleet (1,000,000 exact streams and 64
   logmem tenants at K=65,536) with obs on through ingest_chunks (8
   chunks of 16 a window, the example's 16 cut for time; meter off) and finalize_tiers on the mesh beside an unsharded
   engine over the same chunks: every state leaf, assign_tiers' tiers
   and counts and the metrics snapshot bit-equal; 64 batched_topk, 64
   logmem_update and 8 tier_assign launches; a checkpoint written at 8
   shards restored onto 1 shard, then a second window on both, bit-equal;
   docs/s sharded beside unsharded, and a profile of 4 steps of each
   (as phase 7's). 16c: python -m
   repro_torch.launch.serve --device cuda --tenants 8 --requests 64
   --batch 8 with --mesh 2 and without (two children of the launcher
   batch), retained and ledger lines equal;
   serve() in this process with a 2-shard mesh, every tenant's retained
   set and meter ledgers equal;
17. training with top-K curation (repro_torch.runtime) on the card. 17a:
   reduced llama3.2-1b, 3 train_steps on the card against the port's CPU
   run, each step from the same state and batch (the CPU's, copied):
   loss, per-example NLL and grad_norm within 1e-5 relative, every
   parameter's gradient non-zero and within 1e-4 of its largest
   magnitude, the parameters after the step within 1e-5 of each leaf's
   largest magnitude (where the gradient is within that of zero, AdamW's
   step lr·m/(sqrt(v) + 1e-8) is not fixed by float32 arithmetic: such
   elements, fewer than 1 in 1000, may differ by 2·lr), the reservoir's
   ids equal; flash_attention and its backward launched once a layer a
   gradient. 17b: llama3.2-1b at full width (16 layers, d_model 2048,
   32 heads over 8 KV, vocab 128,256, float32, seeded random weights on
   the card), StreamLoader batches of 8 x 1024, 8 train_steps (lr 3e-4,
   reservoir_k 16): finite losses falling (the last 2 below the first
   2), exactly 128 launches of each flash kernel; step ms (median after
   the first), tokens/s, peak memory, and one profiled step. 17c:
   examples_torch/train_topk_curation.py (the port of
   examples/train_topk_curation.py) at its defaults (lm-100m: d_model
   640, 10 layers, vocab 32,768, seq 256, batch 8, reservoir_k 64, lr
   3e-3, 300 steps) through its run(), which drives train_loop.run with
   the HBM<->host SHP plan, TieredStore and TopKCurator, checkpoints
   under build/ckpt17c: the
   loss falls, the curator's writes and survivors equal a core.simulator
   replay of the NLL stream it saw, the ledger's writes equal its stats,
   its writes beside eq. 11/12's expectation (logged: a falling loss
   ranks early examples first, so the in-order stream writes less), and
   the same NLLs in a random order through a fresh curator within
   tests/test_train_loop.py's 35% of that expectation; then 8 straight
   steps against 4 steps plus 4 resumed from the checkpoint, bit for bit
   under torch.use_deterministic_algorithms(True). 17d: python -m
   repro_torch.launch.train --arch llama3.2-1b --reduced --steps 40
   --device cuda --ckpt-dir build/train17d, a child of the launcher
   batch, sent SIGTERM once its first checkpoint is on disk: exit 0,
   stopped before step 40, and the final checkpoint restores at the
   step its last line names. Checkpoint directories are removed at the
   end;
18. the SSM and hybrid score producers at full width, seeded random
   weights on the card, float32: 18a mamba2-2.7b (64 SSD layers,
   d_model 2560, 80 heads of 64, state 128, chunk 128, vocab 50,280,
   tied; no attention, no FFN) with prompts of 1024 and 18b hymba-1.5b
   (32 attn_ssm_parallel layers: GQA 25 over 5 KV heads, head dim 64,
   RoPE, 3 global and 29 layers under a 1024-token window, beside 50
   SSD heads of 64 with state 16; SiLU-GLU FFN of 5504; vocab 32,001,
   tied) with prompts of 2048, each serving 16 requests in batches of 8
   (32 generated, top-8). Each: the first batch teacher-forced through
   both routes; decode against the forward (the batch's prompt
   prefilled, 8 tokens decoded, each position's logits within 2e-3
   relative and 3e-4 of the logits' largest magnitude of lm.forward's
   over P + 8 tokens: the chunked scan against the recurrence, hymba's
   rolling caches wrapped); one counted single-tenant serve run with
   exact launches (mamba2 0 flash_attention, hymba one a layer a batch,
   64; entropy_scores 62 each) and the retained set against the top-K
   of the scores; prefill ms a batch, decode ms a step, tokens/s, peak
   device memory; profiles of a prefill and of decode steps, and one
   layer's SSD scan profiled alone with its share of the prefill;
19. the MoE score producer: grok-1-314b at full width (d_model 6144, 48
   heads over 8 KV heads, head dim 128, 8 experts of d_ff 32,768, top-2,
   groups of 512 at capacity factor 1.25, attention and head logits
   soft-capped at 30, vocab 131,072, tied; float32, seeded random
   weights on the card) with its depth cut to 2 of its 64 identical
   layers (1.06e10 parameters; the whole model's 3.16e11 fit no card),
   serving 16 requests in batches of 8 (prompts of 1024, 32 generated,
   top-8): the first batch teacher-forced through both routes with
   every layer's routing compared (a choice that moved must sit at a
   near-tie: the two experts' router logits at the first rank that
   differs within 1e-4 of the token's range of logits; rows whose
   experts or dispatch differed are counted and left out of the logits
   limits, and at least half of the rows must stay compared); decode
   against the forward at the dropless capacity factor on 2 rows of 256
   + 8 tokens; one counted serve run with exact launches (4
   flash_attention, 62 entropy_scores), the retained set against the
   top-K, the shares of token-choices dropped at prefill and decode,
   each expert's share of the prefill's choices and its groups' demand
   against the capacity, peak memory; profiles of a prefill and of
   decode steps, with the device spans of the MoE's router, dispatch,
   expert products and combine (its record_function ranges) and their
   shares of each window's device time;
20. the MLA score producer: deepseek-v2-236b at full width (d_model
   5120, MLA with 128 heads, kv_lora 512, q_lora 1536, q/k head dim 128
   nope + 64 rope, v head dim 128; a dense layer of d_ff 12,288, then
   MoE layers of 160 routed experts of d_ff 1536, top-6, 2 shared,
   groups of 512 at capacity factor 1.25; vocab 102,400, untied;
   float32, seeded random weights on the card) with its depth cut to 3
   of its 60 layers (layer 0 and 2 of the 59 identical MoE layers;
   9.33e9 parameters; the whole model's 2.36e11 fit no card), serving
   16 requests in batches of 8 (prompts of 1024, 32 generated, top-8):
   phase 19's checks (the first batch teacher-forced through both
   routes with the routing compared, decode against the forward at the
   dropless capacity on 2 rows of 256 + 8 tokens: the absorbed decode
   over the latent cache against the expanded forward on the kernel; one
   counted serve run with exact launches, 6 flash_attention at head dims
   192 and 128 and 62 entropy_scores; the retained set against the
   top-K; dropped token-choices and each expert's demand), the latent
   caches' bytes beside a GQA KV cache's of the same heads, peak memory,
   and profiles of a prefill and of decode steps with the MoE's and the
   MLA attention's device spans (the flash_attention kernel's share
   among them);
21. the encoder-decoder and the vision-patch frontend at full width and
   depth, float32, seeded random weights on the card, driven through the
   model's own entry points (lm.prefill with the batch's frames or patch
   embeddings, lm.decode_step, entropy_scores on each step's logits), as
   the reference's tests/test_decode.py drives them: 21a whisper-base
   (6 + 6 layers, d_model 512, 8 heads of 64, LayerNorm, GELU, biases,
   learned decoder positions of 448, vocab 51,865, tied; 70,924,800
   parameters), 16 requests in batches of 8 with 1500 frame embeddings
   each (the conv stem is the config's stub), prompts of 416 and 32
   generated; 21b pixtral-12b (cut to 20 of its 40 layers, d_model 5120,
   32 heads over 8 of 128, SiLU-GLU of 14,336, vocab 131,072;
   6,794,982,400 parameters, 25.31 GiB), 8 requests in one batch (depth
   and requests cut for the script's time limit), prompts of 2048 whose
   first 1024 positions are patch embeddings, 32 generated. Each: the first
   batch teacher-forced through both routes (logits within 1e-3, scores
   1e-4); decode against lm.forward over P + 8 tokens (2e-3 relative,
   3e-4 of the logits' scale); one counted run with exact launches (per
   batch whisper 6 encoder + 6 cross + 6 causal flash_attention launches
   at prefill, pixtral 20, none at decode; 31 entropy_scores); prefill ms
   a batch (whisper's lm.encode alone beside it), decode ms a step,
   tokens/s, peak memory, profiles of a prefill and of decode steps.
   Then whisper-base trains: one StreamLoader batch of 8 x 448 tokens
   over 1500 frames through loss_and_grads on both routes, and on the
   CPU port's plain route as a witness of float32's own rounding (loss
   and NLL within 1e-5 relative; the gradients within 1e-4 relative
   (L2), each leaf of both routes within 1e-4 of its own largest
   magnitude, the key bias (whose exact gradient is 0) within 1e-4 of
   its value bias's; the leaves that reach the loss only through
   attention logits logged apart), one train_step timed after a
   warm-up step, with its peak
   memory, and 6 steps of runtime.train_loop.run (finite, falling
   losses), the flash launches and backward launches counted exactly,
   by shape;
22. training the soft-capped and the MLA models on the card, float32,
   seeded random weights, StreamLoader batches of 8 x 1024: 22a
   deepseek-v2-236b at full width cut to layer 0 (MLA at head dims
   (192, 128) and its dense FFN; 1,386,562,560 parameters, whose AdamW
   state fits the card): the step-0 gradients on the kernel route
   against the plain route on the card (loss and NLL within 1e-5
   relative, the gradients as 21a holds them, MLA's query side wq_a,
   q_norm and wq_b on the logits' path; no witness: the port's model
   keeps norms, RoPE, attention logits and router in float32, so no
   float64 route exists), cfg.remat beside no remat (gradients bit-equal
   where two runs without remat are, else within their spread; ms and
   peak memory), then 8 train_steps with AdamW (finite, falling losses;
   one forward and one backward launch a step, counted by shape), ms a
   step, tokens/s, peak memory and a profiled step; 22b grok-1-314b at
   full width cut to 1 of its 64 layers (5,725,292,544 parameters; its
   AdamW state of 85.31 GiB is larger than the card, so no train_step):
   loss_and_grads counted (one capped launch each way) and timed, with
   its peak memory, and its gradients against the plain route's on the
   card, the kernel route's held on the host meanwhile (no witness: no
   float64 copy fits); 22c python -m repro_torch.launch.train --arch
   grok-1-314b and deepseek-v2-236b --reduced on the card, two children
   of the launcher batch (exit 0, finite losses); 22d 17b's llama3.2-1b
   step with cfg.remat beside without: gradients as 22a's rule says,
   then a train_step each way after a warm-up, its ms and peak memory.
23. the model-side mesh and the dry run (repro_torch.parallel's ctx,
   sharding and collectives; repro_torch.launch's dryrun, op_count,
   roofline and inspect_cell). 23a: dryrun.run_cell on the host for
   DRY_ARCHS (dense, MLA and MoE) at train_4k x single, a line a record
   (status, per-chip argument bytes, FLOPs, link-bytes, bottleneck; the
   other seven archs are left to the CLI: the ten take ~40 s of host
   time); 23b: the per-chip slice of llama3.2-1b's train_4k on the
   single pod, batch 1 x 4096 (1/256 of the cell's tokens), full width
   and depth, bfloat16, cfg.remat, as inspect_cell --device cuda runs it
   (flash_attention forward and backward): 2 warm train_steps, 5 timed
   with CUDA events, a profiled one (the top five kernels by device
   time) and one under op_count, whose FLOPs x 256 must equal the dry
   run's global FLOPs within 1% (a check that the meta route and the
   card route count alike, not that the count is right; the bytes are
   printed beside, not held:
   the optimizer's and the weights' bytes do not scale with the batch);
   the step ms beside the roofline's per-chip t_compute and t_memory,
   the peak memory beside the slice's traced peak live bytes plus its
   arguments; launches counted exactly (32 forward, 16 backward a step),
   each at FA_SLICE, the shape phase 3 holds to the plain version;
   23c: compressed_psum over two shards on cuda:0, 64 rounds of error
   feedback on a (4,194,304,) float32 gradient, bit for bit against the
   CPU port's rounds, with the payload bytes, int8 beside float32;
24. the example scripts on the card: each script of examples_torch/
   (the ports of examples/) through its run() in this process, but
   multi_tenant_streams, which phase 6 runs: million_streams --ci
   --devices 8 (64,000 streams and 64 logmem tenants at K=65,536 as 8
   shards on cuda:0), online_replanning, fleet_telemetry,
   cost_attribution, chaos_recovery (whose child, the script run with
   --role child, is a subprocess), serve_topk --tenants 4, quickstart,
   three_tier_cloud and capacity_slo_cloud, each at its defaults, their
   outputs under build/examples24/ (removed at the end). Each script's
   printed lines, exit status, wall seconds and launches of every
   kernel are logged; a script that fails ends the run, one that does
   not launch the kernels its path runs (none for the two host
   scripts) too, and so do serve_topk's tenants not each retaining
   their top-K and quickstart's device reservoir not equal to its host
   curator;
25. the two dense GQA configs no earlier phase serves, at full width,
   float32, seeded random weights on the card, each serving 16 requests
   in batches of 8 (prompts of 1024, 32 generated, top-8) as phase 12
   serves starcoder2-3b (the same function): 25a yi-9b at full depth
   (48 layers, d_model 4096, 32 heads over 4 KV heads of 128, SiLU-GLU
   of 11,008, vocab 64,000, RoPE theta 5e6; 8.83e9 parameters, 32.89
   GiB), 25b command-r-plus-104b cut to 2 of its 64 identical layers
   (d_model 12,288, 96 heads over 8 of 128, SiLU-GLU of 33,792, vocab
   256,000 tied, RoPE theta 75e6; 6.29e9 parameters, the whole model's
   1.04e11 beside). Each: the first batch teacher-forced through both
   routes (logits within 1e-3, scores 1e-4), one counted single-tenant
   serve run with exact launches (a flash_attention launch a layer a
   batch: 96 and 4; 62 entropy_scores), the retained set against the
   top-K of the scores, prefill ms a batch, decode ms a step, peak
   memory, and profiles of a prefill and of decode steps.

The launcher batch starts the subprocesses of 15c, 16c (two), 17d and
22c (two) at once after the build, each its own interpreter and CUDA
context, and watches them in one loop on a thread (SIGTERM to 15c and
17d after their first checkpoints) while phase 3's parity checks run in
this process (nothing is timed there; phase 4's timings wait for the
batch's end); each phase's check then reads its children's output, exit
code and wall. It logs each child's wall and the batch's beside their
sum; the run's last phase clock line sets what the batch saved beside
phase 25's clock.

Phase 3 also holds flash_attention and entropy_scores against their
plain versions (float32 and bfloat16) within 2e-5 (float32) and 2e-2
(bfloat16) relative and absolute, the tolerances of the reference's own
kernel tests: the kernels sum in another order; flash_attention's
float32 output also at most FA_F64_RATIO times as far from a float64
plain version as the float32 plain version.

``python3 chip_smoke.py --fa-ab SRC`` runs none of the phases: it sets
this tree's flash_attention beside the one under SRC (another commit's
src/, unpacked with git archive), timed in turns, with both trees'
distances from a float64 plain route, at the serve shapes of FA_AB
(grok-1's capped and deepseek-v2-236b's at (192, 128) among them), and
its backward at FA_AB_BWD's training shapes; each tree's two turns must
be bit-equal, no forward or backward of this tree slower than SRC's
beyond SRC's own spread between its turns or 1%, and where an
output's bits differ from SRC's, its distance from float64 at most
FA_F64_RATIO times the float32 plain route's. ``python3 chip_smoke.py
--fa-layouts`` times the forward and the backward at deepseek-v2-236b's
launch, (192, 128), under the built layouts and the alternatives of
FA_LAYOUTS, each in its own copy of src/ under build/layouts/.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the
repository's sources beside it, the script exits non-zero and prints no
result.
"""
import dataclasses
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

M = 1_000_000  # streams on the main path
K = 8
DOCS = 256  # docs per stream in a window
CHUNK = 16  # docs per stream per chunk
TIMED_WINDOWS = 1  # phase 5's timed windows after the counted one
MIXED_TIMED_WINDOWS = 1  # phase 8's
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# H100 SXM peak rates outside the tensor cores (NVIDIA's data sheet)
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
TF32_FLOPS = 495e12  # dense TF32 on the tensor cores (the data sheet)
LM_STREAMS, LM_K, LM_CHUNK = 64, 65_536, 8_192  # the example's logmem tenants
LM_FLEET = 4096  # a fleet of huge-K tenants, for the kernel's timing
# (K, streams, docs, chunk) of benchmarks/streams_bench.py's RATIO_SWEEP
RATIO_SWEEP = ((256, 64, 16_384, 512), (4_096, 8, 131_072, 2_048),
               (65_536, 2, 262_144, 8_192))
TF_K, TF_BATCH, TF_BATCHES = 1024, 1 << 20, 64  # the single-stream path
ARCH = "llama3.2-1b"  # the score producer, at full width
SERVE = dict(requests=64, batch=8, prompt_len=1024, gen_len=32, topk=8)
SERVE_TENANTS = 8
# flash_attention at the serve path's prefill: (B, S, H, KV, hd)
FA_PATH = (SERVE["batch"], SERVE["prompt_len"], 32, 8, 64)
ENT_PATH = (SERVE["batch"], 128_256)  # entropy_scores per decode step
ENT_LARGE = (2048, 128_256)  # a large scorer shape, 1.05 GB of float32
# the second model served at full width, with head dim 128
SC_ARCH = "starcoder2-3b"
SC_SERVE = dict(requests=16, batch=8, prompt_len=1024, gen_len=32, topk=8)
FA_SC = (SC_SERVE["batch"], SC_SERVE["prompt_len"], 24, 2, 128)
ENT_SC = (SC_SERVE["batch"], 49_152)
MB_ARCH = "mamba2-2.7b"  # phase 18a: SSD layers only
HY_ARCH = "hymba-1.5b"  # phase 18b: attention and SSD in parallel
SSM_SERVE = {
    MB_ARCH: dict(requests=16, batch=8, prompt_len=1024, gen_len=32, topk=8),
    HY_ARCH: dict(requests=16, batch=8, prompt_len=2048, gen_len=32, topk=8)}
HY_WINDOW = 1024  # hymba's sliding window (29 of its 32 layers)
FA_HY = (SSM_SERVE[HY_ARCH]["batch"], SSM_SERVE[HY_ARCH]["prompt_len"], 25,
         5, 64)
ENT_MB = (SSM_SERVE[MB_ARCH]["batch"], 50_280)  # vector loads
ENT_HY = (SSM_SERVE[HY_ARCH]["batch"], 32_001)  # V % 4 != 0: scalar loads
DECODE_CHECK = 8  # phase 18's decode steps held to lm.forward
# phase 19: grok-1-314b at full width, 2 of its 64 identical attn + moe
# layers (the whole model's 1.26 TB of float32 fits no card)
GK_ARCH = "grok-1-314b"
GK_LAYERS = 2
GK_SERVE = dict(requests=16, batch=8, prompt_len=1024, gen_len=32, topk=8)
GK_CAP = 30.0  # grok-1's attention logit soft-cap
FA_GK = (GK_SERVE["batch"], GK_SERVE["prompt_len"], 48, 8, 128)
ENT_GK = (GK_SERVE["batch"], 131_072)
GK_DECODE = (2, 256)  # rows and prompt tokens of the dropless decode check
# phase 20: deepseek-v2-236b at full width, 3 of its 60 layers: layer 0
# (dense) and 2 of the 59 identical MoE layers (the whole model's 943 GB
# of float32 fits no card)
DS_ARCH = "deepseek-v2-236b"
DS_MOE_LAYERS = 2
DS_SERVE = dict(requests=16, batch=8, prompt_len=1024, gen_len=32, topk=8)
# flash_attention at deepseek's prefill: (B, S, H, q/k head dim, v head dim)
FA_DS = (DS_SERVE["batch"], DS_SERVE["prompt_len"], 128, 192, 128)
ENT_DS = (DS_SERVE["batch"], 102_400)
# phase 21a: whisper-base at full width and depth (6 + 6 layers), its
# encoder over 1500 frame embeddings (max_source_positions; the conv stem
# is the config's stub), decoder prompts of 416 and 32 generated, so that
# every decoder position stays under its 448 (max_target_positions)
WH_ARCH = "whisper-base"
WH_SERVE = dict(requests=16, batch=8, prompt_len=416, gen_len=32, topk=8)
WH_FRAMES = 1500
WH_TRAIN_STEPS = 6  # train_loop.run's steps at full width (after 1 step)
# flash_attention at whisper's launches: (B, Sq, Skv, H, KV, hd), the
# encoder's self-attention and the decoder's cross-attention over the
# frames at serving (416 queries) and training (448: the synthetic
# batches' decoder_len tokens), all non-causal with no window; and the
# decoder's causal self-attention at serving and training
FA_WH_ENC = (WH_SERVE["batch"], WH_FRAMES, WH_FRAMES, 8, 8, 64)
FA_WH_CROSS = (WH_SERVE["batch"], WH_SERVE["prompt_len"], WH_FRAMES, 8, 8,
               64)
FA_WH_CROSS_TRAIN = (WH_SERVE["batch"], 448, WH_FRAMES, 8, 8, 64)
FA_WH_DEC = (WH_SERVE["batch"], WH_SERVE["prompt_len"],
             WH_SERVE["prompt_len"], 8, 8, 64)
FA_WH_DEC_TRAIN = (WH_SERVE["batch"], 448, 448, 8, 8, 64)
ENT_WH = (WH_SERVE["batch"], 51_865)  # V % 4 != 0: scalar loads
# phase 21b: pixtral-12b at full width, prompts of 2048 (the 1024 patch
# embeddings of n_patches, then 1024 text tokens) and 32 generated; its
# requests cut from 16 to one batch and its depth from 40 layers (45.63
# GiB of float32) to 20 (25.31 GiB), to keep the script inside its time
# limit (the widths stay)
PX_ARCH = "pixtral-12b"
PX_SERVE = dict(requests=8, batch=8, prompt_len=2048, gen_len=32, topk=8,
                layers=20)
FA_PX = (PX_SERVE["batch"], PX_SERVE["prompt_len"], 32, 8, 128)
# phase 23b's launches: llama3.2-1b's train_4k a chip (1/256 of its
# tokens), (B, S, H, KV, hd), causal; backward_plan splits its group of 4
FA_SLICE = (1, 4096, 32, 8, 64)
# phase 25: the two dense GQA configs no earlier phase serves, at
# SC_SERVE's run: yi-9b whole (8.83e9 parameters, 32.89 GiB of float32)
# and command-r-plus-104b at full width cut to CR_LAYERS of its 64
# identical layers (6.29e9 parameters with its tied embedding of
# 256,000 x 12,288; the whole model's 386.7 GiB fit no card)
YI_ARCH = "yi-9b"
CR_ARCH = "command-r-plus-104b"
CR_LAYERS = 2
FA_YI = (SC_SERVE["batch"], SC_SERVE["prompt_len"], 32, 4, 128)
FA_CR = (SC_SERVE["batch"], SC_SERVE["prompt_len"], 96, 8, 128)
ENT_YI = (SC_SERVE["batch"], 64_000)
ENT_CR = (SC_SERVE["batch"], 256_000)
# the kernels line's phase 21 and 25 entries, by the FA_CASES labels
# whose largest difference each takes
FA_ENTRIES = (("whisper-base encoder", "whisper-encoder"),
              ("whisper-base cross", "whisper-cross"),
              (PX_ARCH, PX_ARCH), (YI_ARCH, YI_ARCH), (CR_ARCH, CR_ARCH))
# the uncapped flash_attention medians and spreads [min, max] that PERF.md's
# kernel table (row 7) records at the llama3.2-1b, starcoder2-3b and
# hymba-1.5b shapes (NVIDIA H100 80GB HBM3 at 700.00 W) for the forward on
# wgmma (the mma.sync forward's were 0.7573, 1.2921 and 1.7542); phase 4
# holds the uncapped kernel to them, so that a later flag or head-dim pair
# leaves them be
FA_RECORDED = {"flash_attention": (0.5728, 0.5605, 0.6008),
               "flash_attention@hd128": (0.7465, 0.7434, 0.7474),
               "flash_attention@hymba": (1.2080, 1.2002, 1.2135)}
WINDOWS = 5  # timing windows of the redesigned kernels (median, spread)
L2_FLUSH_BYTES = 128 << 20  # written between calls of an L2-cold timing
TF_WINDOW_BATCHES = 12  # filter_then_merge batches in a phase 10 window
# phase 13: examples/online_replanning.py's setting at fleet scale
RP_DOCS, RP_K, RP_CHUNK = 12_000, 64, 64  # window, K, docs a chunk
RP_DRIFT_AT, RP_MULT, RP_ALPHA = 3_000, 8.0, 0.05  # burst, DriftConfig
# tenants of 13a and 13b; 13a's count (like 14b's) is cut so that the
# script stays well inside its time limit
RP_TWO, RP_FOUR = 16_384, 4_096
RP_SAMPLE = 512  # streams of each engine held to the port's CPU run
RP_ORACLE = 16  # 13a streams scored against the process oracle


def log(*args):
    print(*args, flush=True)


class phase_clock:
    """Logs the wall seconds a phase took when its block ends."""

    def __init__(self, label):
        self.label = label

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        log(f"phase clock: {self.label} took {self.seconds:.1f}s")


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events, after
    two warm-up calls)."""
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(outs, refs):
    """Exact comparison of a kernel's outputs with its plain version's:
    equal entries, NaN where the plain version has NaN; returns the
    largest absolute difference (0.0 when equal)."""
    worst = 0.0
    for a, b in zip(outs, refs):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}")
        # equal entries (infinities and NaN against NaN included) differ
        # by 0
        same = a == b
        if a.is_floating_point():
            same |= a.isnan() & b.isnan()
        diff = torch.where(same, 0.0, (a.double() - b.double()).abs())
        worst = max(worst, float(diff.nan_to_num(float("inf")).max()))
        if not bool(same.all()):
            raise AssertionError(f"kernel differs from its plain version "
                                 f"(max abs diff {worst})")
    return worst


def same_bits(outs, refs):
    """A kernel's outputs against its plain version's bit for bit (a -0.0
    differs from a +0.0), NaN where the plain version has NaN (any NaN);
    raises where they differ."""
    for a, b in zip(outs, refs):
        if a.is_floating_point():
            nan = b.isnan()
            if not torch.equal(a.isnan(), nan):
                raise AssertionError("kernel's NaN differ from its plain "
                                     "version's")
            a, b = a[~nan].view(torch.int32), b[~nan].view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError("kernel's bits differ from its plain "
                                 "version's")


def within_tol(outs, refs, tol):
    """A kernel's outputs against its plain version's where the two sum in
    another order: every output finite where the plain one is, and
    |a - b| <= tol * (1 + |b|). Returns the largest absolute
    difference."""
    worst = 0.0
    for a, b in zip(outs, refs):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}")
        a, b = a.double(), b.double()
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        if not bool((diff <= tol * (1 + b.abs())).all()):
            raise AssertionError(f"kernel differs from its plain version "
                                 f"beyond {tol} (max abs diff {worst})")
    return worst


# ---------------------------------------------------------------------------
# phases 1-2: environment and build
# ---------------------------------------------------------------------------

def environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    return smi


def ptxas_usage(text, demangle):
    """(kernel name, its registers and spill bytes) per kernel entry of an
    ``nvcc -Xptxas -v`` report; ``demangle`` maps mangled names to
    demangled ones (or to nothing)."""
    out, entry, spills = [], "?", 0
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "spill stores" in ln:
            spills = sum(map(int, re.findall(r"(\d+) bytes spill", ln)))
        elif "Used" in ln and "registers" in ln:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            out.append((entry, f"{regs} registers, {spills} bytes of spill "
                               f"stores and loads"))
    names = demangle([e for e, _ in out])
    return [(signature_name(names.get(e, e)), u) for e, u in out]


def signature_name(name):
    """A demangled kernel name without its return type, namespace and
    parameter list (template arguments such as "(bool)1" keep theirs)."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    for junk in ("void ", "(anonymous namespace)::", "<unnamed>::"):
        name = name.replace(junk, "")
    return name


def demangle(names):
    """{mangled: demangled} kernel names through the toolkit's cu++filt
    (empty when it is missing)."""
    from repro_torch.kernels import build
    filt = Path(build.nvcc()).parent / "cu++filt"
    if not names or not filt.exists():
        return {}
    got = subprocess.run([str(filt)], input="\n".join(names),
                         capture_output=True, text=True, timeout=60)
    return dict(zip(names, got.stdout.splitlines()))


def build_kernels():
    """Builds every kernel and logs ptxas's reports; returns the SASS
    check of flash_attention (``FlashSass``, started on a thread: it
    runs beside phase 3 and is read after it), or None where the library
    was not compiled now."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build()
    log(f"build: {len(reports)} kernels compiled in "
        f"{time.perf_counter() - t0:.2f}s into {build.BUILD_DIR}")
    for name, text in reports.items():
        for entry, usage in ptxas_usage(text, demangle):
            log(f"build {name}: {entry}: {usage}")
    if "flash_attention" not in reports:
        return None
    from repro_torch.kernels.flash_attention import ops as fa
    fn = build.library("flash_attention").flash_attention_smem_bytes
    for hd, hd_v in fa.HEAD_DIMS:
        log(f"build flash_attention: hd {hd}, hd_v {hd_v}: "
            f"{fn(hd, hd_v, 0)} bytes of dynamic shared memory a forward "
            f"block in float32, {fn(hd, hd_v, 1)} in bfloat16")
    return FlashSass(build)


class FlashSass:
    """flash_attention's kernels as compiled (``cuobjdump --dump-sass`` of
    the library, on a thread from construction): ``check()`` waits for it
    and asserts that every instantiation of flash_fwd, flash_bwd_dq and
    flash_bwd_dkdv holds the Hopper tensor-core product (HGMMA) and the
    TMA load (UTMALDG) and no mma.sync product (HMMA), and logs the
    seconds the dump and its reading took."""

    KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")

    def __init__(self, build):
        self.counts, self.seconds, self.error = {}, 0.0, None
        tool = Path(build.nvcc()).parent / "cuobjdump"
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [str(tool), "--dump-sass", str(build._target("flash_attention"))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def kill(self):
        self.proc.kill()
        self.thread.join()

    def _run(self):
        try:
            sass, err = self.proc.communicate(timeout=300)
            if self.proc.returncode:
                raise RuntimeError(f"cuobjdump exited {self.proc.returncode}:"
                                   f" {err[-2000:]}")
            fn = None
            for ln in sass.splitlines():
                if "Function : " in ln:
                    name = ln.split("Function : ", 1)[1]
                    fn = next((k for k in self.KERNELS if k in name), None)
                    if fn:
                        self.counts.setdefault(fn, []).append(
                            {"HGMMA": 0, "UTMALDG": 0, "HMMA": 0})
                elif fn:
                    for op in ("HGMMA", "UTMALDG", "HMMA"):
                        if op in ln:
                            self.counts[fn][-1][op] += 1
        except BaseException as exc:  # raised again by check()
            self.proc.kill()
            self.error = exc
        self.seconds = time.perf_counter() - self.t0

    def check(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        log(f"build flash_attention sass: cuobjdump --dump-sass and its "
            f"reading took {self.seconds:.2f}s on a thread beside phase 3")
        for fn in self.KERNELS:
            got = self.counts.get(fn, [])
            hg = [c["HGMMA"] for c in got]
            log(f"build flash_attention sass: {len(got)} {fn} "
                f"instantiations; HGMMA {min(hg, default=0)}-"
                f"{max(hg, default=0)} each, UTMALDG in "
                f"{sum(c['UTMALDG'] > 0 for c in got)}, HMMA in "
                f"{sum(c['HMMA'] > 0 for c in got)}")
            if not got or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0
                              or c["HMMA"] for c in got):
                raise AssertionError(f"{fn}: an instantiation without "
                                     f"HGMMA or UTMALDG, or with HMMA")


def log2_rule():
    """The logmem phase is floor(log2(t/K)) in float32: torch.log2 on the
    card must be exact at powers of two, directly and as t/K."""
    p = torch.arange(31, device="cuda", dtype=torch.int32)
    direct = torch.floor(torch.log2(torch.exp2(p.float()))).int()
    t = torch.exp2(p[:16].float()) * LM_K  # t/K = 2^p, t < 2^31
    kf = torch.full_like(t, float(LM_K))
    ratio = torch.floor(torch.log2(torch.maximum(t / kf, torch.ones_like(t))))
    if not (torch.equal(direct, p) and torch.equal(ratio.int(), p[:16])):
        raise AssertionError(f"floor(log2(2^p)) on the card is not p: "
                             f"{direct.tolist()} {ratio.int().tolist()}")
    log("log2 rule: floor(torch.log2(2^p)) == p on the card for p = 0..30, "
        f"and floor(log2(t/K)) == p at K={LM_K}, t = K*2^p, p = 0..15")


# ---------------------------------------------------------------------------
# phases 3-4: kernel parity and timings
# ---------------------------------------------------------------------------

def offset_view(x):
    """A contiguous copy of ``x`` that starts 4 bytes into its storage (a
    base off 16-byte alignment)."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


def plan_text(plan):
    """A launch_plan's (kernel, lanes a row) as log text."""
    kernel, lanes = plan
    return f"{kernel}, {lanes} lane{'s' if lanes > 1 else ''} a row"


def btk_inputs(g, n, kind):
    """Scores and bars: "unfull" (every other bar -inf), "ties" (bars equal
    to scores), "nan" (NaN scores in every 7th row, NaN bars in every 5th,
    -inf bars in every 3rd, signed zeros at zero bars), "zeros" (scores
    made non-positive, every 4th -0.0, so tile maxima of -0.0, with +0.0
    put back in every third row and none left in the next: tile maxima of
    +0.0 and below zero; bars of ±0 and -inf), "plain"."""
    scores = torch.randn(M, n, device="cuda", generator=g)
    bars = torch.randn(M, device="cuda", generator=g)
    if kind == "unfull":
        bars[::2] = float("-inf")
    elif kind == "ties":
        scores[:, ::3] = 0.5
        bars[::2] = 0.5
        bars[1::2] = scores[1::2, n // 2]
    elif kind == "nan":
        scores[::7, n // 3] = float("nan")
        scores[1::4, ::2] = -0.0
        scores[2::4, ::2] = 0.0
        bars[1::4] = 0.0
        bars[2::4] = -0.0
        bars[::3] = float("-inf")
        bars[::5] = float("nan")
    elif kind == "zeros":
        scores = -scores.abs()
        scores[:, ::4] = -0.0
        scores[1::3, 1::8] = 0.0
        scores[2::3, ::4] = -1.0
        bars[::2] = 0.0
        bars[1::4] = -0.0
        bars[3::4] = float("-inf")
    return scores.contiguous(), bars


def ta_inputs(g, k, b, floors, edges=False):
    """Ids with -1 pads against sorted boundaries with ±inf; ``floors``:
    random cascade floors; ``edges``: ids equal to a boundary, ids of
    INT32_MAX - 1 and a boundary there, floors of T - 1 in every third
    row."""
    from repro_torch.kernels.tier_assign import ops as ta
    ids = torch.randint(0, DOCS, (M, k), device="cuda", dtype=torch.int32,
                        generator=g)
    ids[::3, k // 2:] = -1
    rng = np.random.default_rng(k * 10 + b)
    bounds = np.sort(rng.uniform(0, DOCS, (M, b)), axis=1)
    bounds[::5, -1] = np.inf
    bounds[::7, 0] = -np.inf
    if edges:
        bounds[1::11, -1] = np.iinfo(np.int32).max - 1
    bq = torch.tensor(ta.quantize_boundaries(bounds), device="cuda")
    floor = (torch.randint(0, b + 1, (M,), device="cuda", dtype=torch.int32,
                           generator=g) if floors
             else torch.zeros(M, device="cuda", dtype=torch.int32))
    if edges:
        ids[1::2, 0] = bq[1::2, 0]
        ids[1::4, 1] = bq[1::4, -1]
        ids[::6, k - 1] = np.iinfo(np.int32).max - 1
        floor[::3] = b
    return ids, bq, floor


def lm_inputs(g, m, n, kind):
    """Logmem admission inputs: pad ids between live ones (10%), every
    97th row all pad, every third threshold -inf; ``ninf``: all -inf
    (pads must stay inert); ``ties``: thresholds equal to scores;
    ``nan``: NaN scores among live entries (every 7th row) and NaN
    thresholds (every 5th); ``zeros``: scores of -0.0 and +0.0 against
    thresholds of 0.0 and -0.0; ``padtile``: the second tile of every row
    all pad (a tile without a live entry inside a live row)."""
    scores = torch.randn(m, n, device="cuda", generator=g)
    ids = torch.arange(n, dtype=torch.int32, device="cuda").repeat(m, 1)
    ids[torch.rand(m, n, device="cuda", generator=g) < 0.1] = -1
    ids[1::97] = -1
    tau = torch.randn(m, device="cuda", generator=g)
    tau[::3] = float("-inf")
    if kind == "ninf":
        tau.fill_(float("-inf"))
    elif kind == "ties":
        scores[:, ::3] = 0.5
        tau[1::3] = 0.5
    elif kind == "nan":
        scores[::7, n // 3::5] = float("nan")
        tau[::5] = float("nan")
    elif kind == "zeros":
        scores[:, ::3] = -0.0
        scores[:, 1::3] = 0.0
        tau[1::3] = 0.0
        tau[2::3] = -0.0
    elif kind == "padtile":
        from repro_torch.kernels.logmem_update import ops as lm
        bn = lm.tile_width(n)
        ids[:, bn:2 * bn] = -1
    return scores, ids, tau


def tf_inputs(g, n, kind):
    """One stream's scores and a threshold: 0.5, -inf (pad columns
    counted), above every score, 0.5 with NaN scores, or 0.0 against
    "zeros": scores made non-positive, every 4th -0.0, +0.0 put back in
    every other tile of 4096 (tile maxima of +0.0 and -0.0), a few NaN
    (demoted to NEG_BIG)."""
    s = torch.randn(n, device="cuda", generator=g)
    if kind == "nan":
        s[::101] = float("nan")
    elif kind == "zeros":
        s = -s.abs()
        s[::4] = -0.0
        s[7::8192] = 0.0
        s[3::1009] = float("nan")
    thr = {"ninf": float("-inf"), "below": 100.0,
           "zeros": 0.0}.get(kind, 0.5)
    return s, torch.tensor(thr, device="cuda")


def fleet_args(rng, m, t, constrained):
    """A random t-tier fleet (the reference's tests/test_plan_device.py
    draws): cost arrays and, when ``constrained``, capacities on every
    tier, latencies and a read-latency SLO."""
    n = rng.integers(2_000, 1_000_000, m).astype(np.float64)
    k = np.maximum(1, (n * rng.uniform(0.001, 0.1, m))).astype(np.float64)
    r = lambda s: 10.0 ** rng.uniform(-8, -3, s)  # noqa: E731
    args = (r((m, t)), r((m, t)), r((m, t)), n, k, np.ones(m))
    if not constrained:
        return args, {}
    cap = k[:, None] * rng.uniform(0.05, 2.0, (m, t))
    cap[rng.random((m, t)) < 0.3] = np.inf
    lat = np.sort(10.0 ** rng.uniform(-3, 2, (m, t)), axis=1)
    slo = np.where(rng.random(m) < 0.6,
                   np.sqrt(lat[:, 0] * lat[:, -1]), np.inf)
    return args, {"cap": cap, "lat": lat, "slo": slo}


def capture_plan_solve(plan):
    """Run ``plan()`` and return the inputs of every plan_solve launch it
    made: (fs, const, combos, grids) tuples on the card."""
    from repro_torch.kernels.plan_solve import ops as ps
    seen = []
    real = ps.plan_solve

    def recording(*args):
        seen.append(args)
        return real(*args)

    ps.plan_solve = recording
    try:
        plan()
    finally:
        ps.plan_solve = real
    return seen


def as_dtype(args, dtype):
    """plan_solve inputs with every float tensor cast to ``dtype``."""
    cast = lambda x: x.to(dtype) if x.is_floating_point() else x  # noqa: E731
    fs, const, combos, grids = args
    return (cast(fs), cast(const), combos,
            None if grids is None else tuple(cast(x) for x in grids))


def plan_solve_inputs():
    """plan_solve's inputs at the main path's shapes — the four launches
    of the unconstrained 1,000,000-stream plan (float32) and the four of
    a constrained re-solve of 400,000 of its streams under a hot-tier cap
    (float64) — and at a 4-tier constrained fleet's (float64)."""
    from repro_torch.core import shp
    rng = np.random.default_rng(7)
    cw, cr, cs, n, kv, rpw = fleet_cost_arrays(rng, M, DOCS, K)
    sub = slice(0, 400_000)
    cap = np.full((400_000, 3), np.inf)
    cap[:, 0] = rng.uniform(0.5, 6.0, 400_000)
    args4, cons4 = fleet_args(rng, 4096, 4, True)
    return {
        "unconstrained": capture_plan_solve(
            lambda: shp.plan_ntier_arrays(cw, cr, cs, n, kv, rpw)),
        "constrained": capture_plan_solve(
            lambda: shp.plan_ntier_arrays(
                cw[sub], cr[sub], cs[sub], n[sub], kv[sub], rpw[sub],
                cap=cap)),
        "4-tier": capture_plan_solve(
            lambda: shp.plan_ntier_arrays(*args4, **cons4,
                                          backend="device")),
        "re-solve": resolve_solve_inputs(),
    }


def resolve_solve_inputs():
    """plan_solve's inputs at the online re-solve's four-tier shape
    (phase 13b): all RP_FOUR of its tenants flagged at once, at random
    positions after the burst and random rates; float64, masked (a pair
    cap on tier 1), +inf terms (tier 3's folded capacity mask)."""
    from repro_torch.online import replan, replan_device
    rng = np.random.default_rng(14)
    st = replan.Replanner(four_tier_fleet(rng, RP_FOUR),
                          constraints=rp_constraints(True))._stacks[4]
    n = st["n"]
    args = [st[key] for key in ("cw", "cr", "cs", "n", "k", "rpw", "cap",
                                "lat", "slo")]
    args += [np.floor(rng.uniform(RP_DRIFT_AT / RP_DOCS, 0.95, RP_FOUR) * n),
             rng.uniform(1.0, RP_MULT, RP_FOUR),
             np.sort(rng.uniform(0, 1, (RP_FOUR, 3)) * n[:, None], axis=1)]
    return capture_plan_solve(
        lambda: replan_device.solve_group(*args, device="cuda"))


def blocked_resolve_cases(args):
    """The re-solve's inputs with every tuple of streams 0, 97, 194, ...
    +inf (all infeasible: they must give (+inf, 0)), and with an all-+inf
    copy of the subset ahead of it (S = 2: a finite winner must come from
    the second subset)."""
    fs, const, combos, grids = args
    stream = fs.clone()
    stream[::97] = float("inf")
    cat = lambda x: torch.cat([x, x], dim=1).contiguous()  # noqa: E731
    subset = (torch.cat([torch.full_like(fs, float("inf")), fs],
                        dim=1).contiguous(), cat(const), combos,
              tuple(cat(x) for x in grids))
    return {"re-solve, all-+inf streams": (stream, const, combos, grids),
            "re-solve, all-+inf first subset": subset}


def ps_shape(args):
    fs, _, combos, grids = args
    m, s, j, c = fs.shape
    return (f"M={m} S={s} J={j} C={c} G={combos.shape[0]} "
            f"{'masked' if grids is not None else 'unmasked'} "
            f"{str(fs.dtype).replace('torch.', '')}")


def ps_nan_seams(g, m, s, j, c):
    """Terms where the last subset is the cheapest but holds a NaN in its
    last tuple alone (even streams), and where the first subset is the
    cheapest but holds a NaN while every later one is infeasible (streams
    1, 5, 9, ...: those return (+inf, 0), never a later subset's
    winner)."""
    from repro_torch.kernels.plan_solve import ops as ps
    fs = torch.randn(m, s, j, c, device="cuda", dtype=torch.float64,
                     generator=g)
    const = torch.randn(m, s, 3, device="cuda", dtype=torch.float64,
                        generator=g)
    fs[:, -1] -= 10
    fs[::2, -1, 0, -1] = float("nan")  # c0 = C-1: the last tuple alone
    fs[1::4, 0] -= 20
    fs[1::4, 0, 0, 0] = float("nan")
    const[1::4, 1:, 0] = float("inf")
    combos = torch.as_tensor(ps.monotone_combos(c, j).astype(np.uint8),
                             device="cuda")
    return fs, const, combos, None


def ps_edge_cases(g):
    """Edge cases at the widest main-path group shape (M=1,000,000, S=3,
    J=2, C=8): exact cost ties across tuples and subsets, NaN terms,
    streams masked out entirely, with lower bounds and a budget; NaNs at
    the reductions' seams (``ps_nan_seams``) there and at the 4-tier
    fleet's widest shape (M=4096, J=3, C=31: one block a stream), with
    ties there too."""
    from repro_torch.kernels.plan_solve import ops as ps
    m, s, j, c = M, 3, 2, 8
    dev = "cuda"
    fs = torch.randint(0, 3, (m, s, j, c), device=dev, generator=g).double()
    const = torch.randint(0, 3, (m, 1, 3), device=dev,
                          generator=g).double().expand(m, s, 3).contiguous()
    ties = (fs, const)
    fs = torch.randn(m, s, j, c, device=dev, dtype=torch.float64, generator=g)
    fs[::7, 0, 0, 0] = float("nan")
    const = torch.randn(m, s, 3, device=dev, dtype=torch.float64, generator=g)
    const[::11, 1, 0] = float("inf")
    cand = torch.sort(torch.rand(m, s, c, device=dev, dtype=torch.float64,
                                 generator=g) * 100, dim=2).values
    kf = torch.rand(m, device=dev, dtype=torch.float64, generator=g) * 60 + 20
    masks = [torch.rand(m, s, c, device=dev, generator=g) < 0.8
             for _ in range(j)]
    masks[0][::13] = False
    rhs = torch.rand(m, s, device=dev, dtype=torch.float64, generator=g) - 0.3
    kw = dict(cand=cand, kf=kf, masks=masks,
              pair_caps=[kf[:, None] * torch.rand(
                  m, s, device=dev, dtype=torch.float64, generator=g) * 1.5],
              alpha=(torch.rand(m, s, j, device=dev, dtype=torch.float64,
                                generator=g) - 0.5) / 50,
              rhs=rhs, atol=1e-9 * rhs.abs() + 1e-15)
    combos = torch.as_tensor(ps.monotone_combos(c, j).astype(np.uint8),
                             device=dev)
    wide = torch.randint(0, 3, (4096, 2, 3, 31), device=dev, generator=g)
    wide_const = torch.randint(0, 3, (4096, 1, 3), device=dev, generator=g)
    return {"ties": (*ties, combos, None),
            "NaN terms, infeasible subsets and streams, lower bounds and "
            "budget": ps.solve_inputs(fs, tuple(const.unbind(2)), **kw),
            "NaN seams": ps_nan_seams(g, m, s, j, c),
            "ties at G=5456": (
                wide.double(), wide_const.double().expand(4096, 2, 3)
                .contiguous(), torch.as_tensor(
                    ps.monotone_combos(31, 3).astype(np.uint8), device=dev),
                None),
            "NaN seams at G=5456": ps_nan_seams(g, 4096, 3, 3, 31)}


# (M, N, lm_inputs kind, base 4 bytes off 16-byte alignment, label):
# the paths' shapes, then the seams of the block-a-tile kernels: grids
# of 1 and of 131, 133 and 1,025 streams (either side of the card's 132
# SMs and of 8 blocks an SM), one whole tile, a partial tile of one
# column, short rows (a tile of 128 columns holding 36 or 40), NaN, signed
# zeros, an all-pad tile in a live row, a misaligned base
LM_PARITY = (
    (LM_STREAMS, LM_CHUNK, "plain", False, "deployment chunk"),
    (LM_FLEET, LM_CHUNK, "plain", False, "fleet of huge-K tenants"),
    (LM_STREAMS, LM_CHUNK, "ninf", False, "tau=-inf everywhere"),
    (1, LM_CHUNK, "plain", False, "one stream"),
    (131, LM_CHUNK, "ties", False, "131 streams, ties"),
    (133, LM_CHUNK, "plain", False, "133 streams"),
    (1025, LM_CHUNK, "ninf", False, "1,025 streams, tau=-inf"),
    (LM_FLEET, 512, "plain", False, "N=512, one whole tile"),
    (LM_FLEET, 513, "ninf", False, "N=513, a last tile of one column"),
    (LM_FLEET, 600, "ties", False, "N=600, two tiles, ties"),
    (LM_FLEET, 36, "plain", False, "N=36, a short row"),
    (LM_FLEET, 40, "plain", False, "N=40"),
    (LM_FLEET, 16, "ninf", False, "N=16, one thread per row"),
    (LM_FLEET, 8190, "plain", False, "N=8190, 4-byte loads"),
    (LM_STREAMS, LM_CHUNK, "nan", False,
     "NaN scores among live entries, tau=NaN"),
    (LM_STREAMS, LM_CHUNK, "zeros", False, "±0 scores against tau=±0"),
    (LM_STREAMS, LM_CHUNK, "padtile", False, "an all-pad tile in live rows"),
    (LM_STREAMS, LM_CHUNK, "nan", True,
     "base 4 bytes off 16-byte alignment, NaN"),
    (LM_FLEET, 36, "zeros", True, "N=36 off 16-byte alignment, ±0"))


def lm_plan_text(plan):
    """A logmem launch_plan's (kernel, threads a block) as log text."""
    kernel, threads = plan
    how = "a thread a row" if kernel == "admit_narrow" else "a block a tile"
    return f"{kernel}, {threads} threads a block, {how}"


def lm_parity(g):
    """logmem_admit against its plain version at LM_PARITY's cases, each
    logging the kernel its launch_plan picks; the largest difference (0.0:
    exact, NaN where the plain version has NaN)."""
    from repro_torch.kernels.logmem_update import ops as lm
    worst = 0.0
    for m, n, kind, offset, label in LM_PARITY:
        args = lm_inputs(g, m, n, kind)
        if offset:
            args = (offset_view(args[0]), offset_view(args[1]), args[2])
        plan = lm.launch_plan(*args)
        out = lm.logmem_admit(*args)
        torch.cuda.synchronize()
        ref = lm.reference(*args)
        err = max_abs_err(out, ref)
        same_bits(out, ref)
        worst = max(worst, err)
        log(f"parity logmem_update [{label}; pad ids between live ones, "
            f"all-pad rows] M={m} N={n}; {lm_plan_text(plan)}: exact, equal "
            f"bits (max abs diff {err})")
    return worst


def kernel_parity():
    from repro_torch.kernels.batched_topk import ops as btk
    from repro_torch.kernels.tier_assign import ops as ta
    from repro_torch.kernels.topk_filter import ops as tf
    g = torch.Generator(device="cuda").manual_seed(0)
    from repro_torch.kernels.plan_solve import ops as ps
    errs = {"batched_topk": 0.0, "tier_assign": 0.0, "logmem_update": 0.0,
            "topk_filter": 0.0, "plan_solve": 0.0}
    for n, kind, offset, label in (
            (16, "unfull", False, "-inf bars: pad columns counted"),
            (16, "ties", False, "bars equal to scores"),
            (16, "plain", False, "main-path width"),
            (16, "nan", False, "NaN scores and bars, signed zeros"),
            (16, "nan", True, "base 4 bytes off 16-byte alignment, NaN"),
            (7, "unfull", False, "N=7, -inf bars"),
            (600, "unfull", False, "N=600, two tiles, -inf bars"),
            (16, "zeros", False, "tile maxima of ±0"),
            (16, "zeros", True, "tile maxima of ±0, base off alignment"),
            (7, "zeros", False, "N=7, tile maxima of ±0"),
            (600, "zeros", False, "N=600, tile maxima of ±0")):
        s, b = btk_inputs(g, n, kind)
        if offset:
            s = offset_view(s)
        plan = btk.launch_plan(s, b)
        out = btk.batched_topk_filter(s, b)
        torch.cuda.synchronize()
        ref = btk.reference(s, b)
        err = max_abs_err(out, ref)
        same_bits(out, ref)
        errs["batched_topk"] = max(errs["batched_topk"], err)
        log(f"parity batched_topk [{label}] M={M} N={n}; {plan_text(plan)}: "
            f"exact, equal bits (max abs diff {err})")
    for k, b, floors, edges, offset, label in (
            (8, 2, True, False, False, "floors, ±inf bounds, -1 pads"),
            (8, 2, False, False, False, "no floors"),
            (8, 2, True, True, False, "ids at boundaries and INT32_MAX-1, "
             "floors T-1"),
            (8, 2, True, True, True, "base 4 bytes off 16-byte alignment"),
            (5, 3, True, False, False, "K=5, 4 tiers"),
            (16, 7, True, True, False, "K=16, 8 tiers"),
            (40, 2, True, False, False, "K=40, two lane rounds")):
        ids, bq, floor = ta_inputs(g, k, b, floors, edges)
        if offset:
            ids = offset_view(ids)
        plan = ta.launch_plan(ids, bq, floor)
        out = ta.tier_assign(ids, bq, floor)
        torch.cuda.synchronize()
        err = max_abs_err(out, ta.reference(ids, bq, floor, b + 1))
        errs["tier_assign"] = max(errs["tier_assign"], err)
        log(f"parity tier_assign [{label}] M={M} K={k} B={b}; "
            f"{plan_text(plan)}: exact (max abs diff {err})")
    errs["logmem_update"] = lm_parity(g)
    f32 = torch.float32
    for n, kind, dtype, offset, label in (
            (TF_BATCH, "plain", f32, False, "main-path batch"),
            (TF_BATCH * TF_BATCHES, "plain", f32, False, "2^26 scores"),
            (5000, "plain", f32, False, "N=5000, partial tile"),
            (5000, "ninf", f32, False, "thr=-inf, pads counted"),
            (TF_BATCH, "nan", f32, False, "NaN scores"),
            (TF_BATCH, "below", f32, False, "all below thr"),
            (TF_BATCH, "plain", torch.bfloat16, False, "bfloat16 scores"),
            (4097, "ninf", f32, False, "N=4097, 4-byte loads"),
            (TF_BATCH, "zeros", f32, False, "tile maxima of ±0"),
            (5000, "zeros", f32, False, "N=5000, tile maxima of ±0"),
            (4097, "zeros", f32, False, "N=4097, tile maxima of ±0"),
            (100, "ninf", f32, False, "N=100, one tile of 128"),
            (TF_BATCH, "zeros", f32, True,
             "base 4 bytes off 16-byte alignment, ±0")):
        s, thr = tf_inputs(g, n, kind)
        s = s.to(dtype)
        if offset:
            s = offset_view(s)
        plan = tf.launch_plan(s.to(f32))
        out = tf.topk_filter(s, thr)
        torch.cuda.synchronize()
        ref = tf.reference(s, thr)
        err = max_abs_err(out, ref)
        same_bits(out, ref)
        errs["topk_filter"] = max(errs["topk_filter"], err)
        log(f"parity topk_filter [{label}] N={n}; {tf_plan_text(plan)}: "
            f"exact, equal bits (max abs diff {err})")
    solves = plan_solve_inputs()
    cases = [(f"{name} launch {i}", as_dtype(a, dtype))
             for name, launches in solves.items()
             for i, a in enumerate(launches)
             for dtype in (torch.float32, torch.float64)]
    for label, args in ps_edge_cases(g).items():
        cases += [(label, as_dtype(args, dtype))
                  for dtype in (torch.float32, torch.float64)]
    cases += list(blocked_resolve_cases(solves["re-solve"][0]).items())
    for label, args in cases:
        out = ps.plan_solve(*args)
        torch.cuda.synchronize()
        err = max_abs_err(out, ps.reference(*args))
        errs["plan_solve"] = max(errs["plan_solve"], err)
        if label.startswith("NaN seams"):  # (+inf, 0) where subset 0 held NaN
            cut = out[0][1::4], out[1][1::4]
            if not (torch.isinf(cut[0]).all() and (cut[1] == 0).all()):
                raise AssertionError(f"plan_solve [{label}]: a NaN-skipped "
                                     f"first subset did not give (+inf, 0)")
        if label == "re-solve, all-+inf streams":
            cut = out[0][::97], out[1][::97]
            if not (torch.isinf(cut[0]).all() and (cut[1] == 0).all()):
                raise AssertionError(f"plan_solve [{label}]: an infeasible "
                                     f"stream did not give (+inf, 0)")
        if label == "re-solve, all-+inf first subset":
            fin = torch.isfinite(out[0])
            if not (bool(fin.any()) and bool(
                    (out[1][fin] >= args[2].shape[0]).all())):
                raise AssertionError(f"plan_solve [{label}]: a winner came "
                                     f"from the all-+inf subset")
        if label.startswith("re-solve") and not bool(
                torch.isinf(args[0]).any()):
            raise AssertionError(f"plan_solve [{label}]: no +inf term")
        log(f"parity plan_solve [{label}] {ps_shape(args)}; "
            f"{ps_kernel(args)[0]}: exact (val and idx; max abs diff {err})")
    return errs, solves


def device_parts(fn, reps, kernels, attempts=3):
    """{kernel: mean device ms per launch} for each kernel ``fn``
    launches, named by a substring in ``kernels`` (one name or a tuple),
    over ``reps`` calls. torch.profiler after a warm-up call: the
    kernels' own time, without the host's launch overhead, which a
    CUDA-event timing of a short kernel measures.

    The profiler drops kernel records now and then (seen for 3 us and
    0.1 ms kernels launched back to back: from a few records to all of
    them in one profile), so a profile that does not hold exactly
    ``reps`` launches of every kernel is taken again, up to ``attempts``
    times in all. When none is complete, each mean is taken over the
    records of the fullest profile, which must hold at least a tenth of
    the launches of every kernel; the timing fails otherwise, and when a
    profile holds more records than launches (another kernel matching a
    name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if isinstance(kernels, str):
        kernels = (kernels,)
    fn()
    torch.cuda.synchronize()
    best, held = None, -1
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        runs = {k: [e for e in dev if k in e.name] for k in kernels}
        for k, r in runs.items():
            if len(r) > reps:
                raise AssertionError(f"profiled {len(r)} launches of {k} "
                                     f"for {reps} calls")
        n = min(len(r) for r in runs.values())
        if n > held:
            best, held = runs, n
        if n == reps:
            break
        held_now = ", ".join(f"{len(r)} launches of {k}"
                             for k, r in runs.items())
        log(f"profile {attempt} of {attempts} held {held_now}, not {reps} "
            f"each")
    if held < max(1, reps // 10):
        raise AssertionError(f"no profile of {kernels} held a tenth of its "
                             f"{reps} launches in {attempts} attempts")
    if held < reps:
        log(f"timing {kernels}: means over the records the fullest profile "
            f"held ({held} or more of {reps} launches each)")
    return {k: sum(e.time_range.end - e.time_range.start for e in r)
            / len(r) / 1e3 for k, r in best.items()}  # us -> ms


def device_ms(fn, reps, kernels):
    """Mean device ms per call of ``fn``: ``device_parts`` summed (a call
    that launches two kernels counts both)."""
    return sum(device_parts(fn, reps, kernels).values())


def device_ms_windows(fn, reps, kernels, windows=5):
    """``device_ms`` over ``windows`` timing windows: (median, min, max)
    ms per call, so a kernel's time is read beside its spread, and each
    kernel's median ms per launch."""
    runs = [device_parts(fn, reps, kernels) for _ in range(windows)]
    got = sorted(sum(r.values()) for r in runs)
    parts = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    return statistics.median(got), got[0], got[-1], parts


def ps_work(args):
    """(bytes, floating-point operations) one plan_solve launch needs:
    every input read once, the outputs written once; per tuple the step
    terms and constants added, and when masked the latency deltas added
    and each pairwise lower bound's slack (a multiply and a subtract)."""
    fs, const, combos, grids = args
    m, s, j, c = fs.shape
    g = combos.shape[0]
    tensors = [fs, const, combos] + list(grids or ())
    nbytes = sum(x.numel() * x.element_size() for x in tensors)
    nbytes += m * (fs.element_size() + 4)
    per_tuple = j + const.shape[2]
    if grids is not None:
        per_tuple += j + 2 * (j - 1)
    return nbytes, m * s * (g * per_tuple + (grids is not None))


def ps_kernel(args):
    """(profiler name, log text) of the kernel plan_solve launches for
    ``args``: the mapping ``launch_plan`` picks."""
    from repro_torch.kernels.plan_solve import ops as ps
    mapping, tile, threads, smem = ps.launch_plan(*args)
    how = (f"{tile} streams a block, a thread each" if mapping == "rows"
           else "a block a stream")
    return (f"plan_solve_{mapping}",
            f"plan_solve_{mapping}: {how}, {threads} threads, {smem} bytes "
            f"of shared memory")


def plan_solve_timings(solves):
    """plan_solve's device time per launch (profiler; median of WINDOWS
    windows of 20 calls, with the spread), wrapper and plain times and
    bound; a solve is the sum of its launches (their medians, the spread
    from the sums of their minima and maxima). The main path's
    unconstrained solve goes into the kernels line."""
    from repro_torch.kernels.plan_solve import ops as ps
    out = {}
    for name, launches in solves.items():
        tot = {"ms": 0.0, "lo": 0.0, "hi": 0.0, "call_ms": 0.0,
               "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
               "ops_ms": 0.0}
        for i, args in enumerate(launches):
            nbytes, flops = ps_work(args)
            kernel, how = ps_kernel(args)
            med, lo, hi, _ = device_ms_windows(
                lambda: ps.plan_solve(*args), 20, kernel, WINDOWS)
            t = {"ms": med, "lo": lo, "hi": hi,
                 "call_ms": cuda_ms(lambda: ps.plan_solve(*args), 20),
                 "plain_ms": cuda_ms(lambda: ps.reference(*args), 3),
                 "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                 "ops_ms": flops / PEAK_FLOPS[args[0].dtype] * 1e3}
            t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
            for key in tot:
                tot[key] += t[key]
            log(f"timing plan_solve [{name} launch {i}: {ps_shape(args)}; "
                f"{how}]: kernel {med:.4f} ms on the device (profiler, "
                f"median of {WINDOWS} windows of 20 calls; min {lo:.4f}, max "
                f"{hi:.4f}); {t['call_ms']:.4f} ms per wrapper call; plain "
                f"{t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
                f"(bytes {t['bytes_ms']:.4f} at 3.35 TB/s, operations "
                f"{t['ops_ms']:.4f})")
        tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                           else "operations")
        tot["library_ms"] = None
        out[name] = tot
        log(f"timing plan_solve [{name}, {len(launches)} launches per "
            f"solve]: kernel {tot['ms']:.4f} ms [{tot['lo']:.4f}-"
            f"{tot['hi']:.4f}] (sum of the launches' medians [of their "
            f"minima - maxima]); wrapper calls {tot['call_ms']:.4f} ms; "
            f"plain {tot['plain_ms']:.4f} ms; bound {tot['bound_ms']:.4f} "
            f"ms ({tot['bound_by']})")
    log("library_ms plan_solve: null — no single PyTorch call gives the "
        "masked joint first minimum over monotone tuples and subsets")
    return out["unconstrained"]


def tf_plan_text(plan):
    """A topk_filter launch_plan's (kernel, reason) as log text."""
    kernel, reason = plan
    return f"{kernel} ({reason})"


def l2_cold(fn, flush):
    """``fn`` after writing all of ``flush`` (a buffer larger than the
    card's 50 MB L2), so each call finds its inputs in device memory and
    the L2 full of dirty lines."""
    def run():
        flush.fill_(1.0)
        return fn()
    return run


def kernel_timings():
    """Phase 4 for the four scan kernels: each the median of WINDOWS
    profiled windows of 100 calls with its spread, its launch plan, its
    wrapper and plain times and its byte bound; logmem_update at the
    mixed fleet's chunk and topk_filter at one batch (inputs of 4.7 and
    5.2 MB, which stay in L2 between back-to-back calls) also L2-cold,
    with L2_FLUSH_BYTES written before each call and only the kernel's
    own records counted."""
    from repro_torch.kernels.batched_topk import ops as btk
    from repro_torch.kernels.logmem_update import ops as lm
    from repro_torch.kernels.tier_assign import ops as ta
    from repro_torch.kernels.topk_filter import ops as tf
    g = torch.Generator(device="cuda").manual_seed(1)
    n_bounds, n_tiers = 2, 3
    cases = []  # (key, kernel name in the profile, call, plain, bytes,
    plans = {}  # shape); the launch plan of each key as log text
    s, b = btk_inputs(g, CHUNK, "plain")
    cases.append((
        "batched_topk", "scan_", lambda: btk.batched_topk_filter(s, b),
        lambda: btk.reference(s, b),
        4 * M * CHUNK + 4 * M + M * CHUNK + 8 * M,
        f"scores ({M}, {CHUNK}) f32, bars ({M},) f32"))
    plans["batched_topk"] = plan_text(btk.launch_plan(s, b))
    ids, bq, floor = ta_inputs(g, K, n_bounds, True)
    cases.append((
        "tier_assign", "assign_", lambda: ta.tier_assign(ids, bq, floor),
        lambda: ta.reference(ids, bq, floor, n_tiers),
        4 * M * K + 4 * M * n_bounds + 4 * M + 4 * M * K + 4 * M * n_tiers,
        f"ids ({M}, {K}) i32, bounds ({M}, {n_bounds}) i32"))
    plans["tier_assign"] = plan_text(ta.launch_plan(ids, bq, floor))
    # the path's shape first (it goes into the kernels line), then a
    # large one
    lm_tiles = -(-LM_CHUNK // lm.tile_width(LM_CHUNK))
    for m, key in ((LM_STREAMS, "logmem_update"),
                   (LM_FLEET, "logmem_update@fleet")):
        a = lm_inputs(g, m, LM_CHUNK, "plain")
        cases.append((
            key, "admit_", lambda a=a: lm.logmem_admit(*a),
            lambda a=a: lm.reference(*a),
            8 * m * LM_CHUNK + 4 * m + m * LM_CHUNK + 12 * m * lm_tiles,
            f"scores and ids ({m}, {LM_CHUNK}), tau ({m},)"))
        plans[key] = lm_plan_text(lm.launch_plan(*a))
    for n, key in ((TF_BATCH, "topk_filter"),
                   (TF_BATCH * TF_BATCHES, "topk_filter@2^26")):
        a = tf_inputs(g, n, "plain")
        cases.append((
            key, "filter_", lambda a=a: tf.topk_filter(*a),
            lambda a=a: tf.reference(*a),
            4 * n + 4 + n + 8 * -(-n // tf.tile_width(n)),
            f"scores ({n},) f32, thr () f32"))
        plans[key] = tf_plan_text(tf.launch_plan(a[0]))
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    out = {}
    for key, kernel, call, plain, nbytes, shape in cases:
        med, lo, hi, _ = device_ms_windows(call, 100, kernel, WINDOWS)
        out[key] = {"ms": med,
                    "call_ms": cuda_ms(call, 200),
                    "plain_ms": cuda_ms(plain, 10),
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes", "library_ms": None}
        t = out[key]
        log(f"timing {key} [{shape}]: kernel {t['ms']:.4f} ms on the device "
            f"(profiler, {plans[key]}; median of {WINDOWS} windows of 100 "
            f"calls; min {lo:.4f}, max {hi:.4f}); {t['call_ms']:.4f} ms per "
            f"wrapper call (CUDA events, host launch included); plain "
            f"{t['plain_ms']:.4f} ms; byte bound {t['bound_ms']:.4f} ms at "
            f"3.35 TB/s ({t['bound_ms'] / med:.0%} of it L2-warm)")
        if key in ("logmem_update", "topk_filter"):
            cmed, clo, chi, _ = device_ms_windows(l2_cold(call, flush), 100,
                                                  kernel, WINDOWS)
            log(f"timing {key} L2-cold [{shape}]: kernel {cmed:.4f} ms on the "
                f"device (profiler, {L2_FLUSH_BYTES >> 20} MiB written before "
                f"each call, the kernel's own records alone; median of "
                f"{WINDOWS} windows of 100 calls; min {clo:.4f}, max "
                f"{chi:.4f}); {t['bound_ms'] / cmed:.0%} of its byte bound "
                f"{t['bound_ms']:.4f} ms (L2-warm {med:.4f} ms, "
                f"{t['bound_ms'] / med:.0%})")
    del flush
    for name, call in (("batched_topk", "torch.gt gives the mask alone"),
                       ("tier_assign", "torch.bucketize gives the uncapped "
                        "tier index alone"),
                       ("logmem_update", "torch.gt with an id gate gives "
                        "the mask alone"),
                       ("topk_filter", "torch.gt gives the mask alone")):
        log(f"library_ms {name}: null — no single PyTorch call gives the "
            f"kernel's mask (or tiers) together with its per-tile or "
            f"per-tier counts and maxima ({call})")
    return out


# (label, B, Sq, Skv, H, KV, hd, causal, window, softcap) for
# flash_attention; a cap below 10 comes with q scaled by FA_CAP_QS, so that
# the logits reach about ±50 and the cap bites hard
FA_CAP_QS = 8.0
FA_CASES = (("serve prefill", *FA_PATH[:2], *FA_PATH[1:], True, 0, 0.0),
            ("causal", 1, 128, 128, 2, 2, 64, True, 0, 0.0),
            ("window 16", 1, 128, 128, 2, 2, 32, True, 16, 0.0),
            ("window 64", 1, 128, 128, 2, 2, 32, True, 64, 0.0),
            ("non-causal", 1, 64, 64, 2, 2, 32, False, 0, 0.0),
            ("ragged Sq = Skv = 100", 1, 100, 100, 2, 2, 64, True, 0, 0.0),
            ("Sq < Skv", 1, 64, 192, 2, 2, 32, True, 0, 0.0),
            ("GQA 32 over 8, ragged", 2, 300, 300, 32, 8, 64, True, 0, 0.0),
            ("GQA, Sq < Skv, window 100", 1, 200, 520, 8, 2, 64, True, 100,
             0.0),
            ("Sq > Skv: rows with no key", 1, 40, 24, 2, 2, 16, True, 0, 0.0),
            ("starcoder2-3b prefill, hd 128", *FA_SC[:2], *FA_SC[1:], True,
             0, 0.0),
            ("GQA 24 over 2, ragged, hd 128", 2, 300, 300, 24, 2, 128, True,
             0, 0.0),
            ("window 4096, Skv > 4096, hd 128", 1, 4608, 4608, 8, 2, 128,
             True, 4096, 0.0),
            ("Sq > Skv: rows with no key, hd 128", 1, 40, 24, 2, 1, 128, True,
             0, 0.0),
            ("hymba-1.5b prefill, 25 over 5, window 1024", *FA_HY[:2],
             *FA_HY[1:], True, HY_WINDOW, 0.0),
            ("GQA 25 over 5, ragged, window 100", 1, 300, 300, 25, 5, 64,
             True, 100, 0.0),
            ("grok-1 prefill, 48 over 8, cap 30", *FA_GK[:2], *FA_GK[1:],
             True, 0, GK_CAP),
            ("ragged, window 100, cap 5 biting", 1, 300, 300, 6, 2, 64, True,
             100, 5.0),
            ("GQA 48 over 8, ragged Sq < Skv, cap 5, hd 128", 1, 200, 333,
             48, 8, 128, True, 0, 5.0),
            ("Sq > Skv: rows with no key, cap 2", 1, 40, 24, 2, 1, 16, True,
             0, 2.0),
            ("Sq < Skv past two chunks, window 1500, cap 5 biting, hd 128",
             1, 700, 2200, 8, 2, 128, True, 1500, 5.0),
            # non-causal with no window: whisper-base's encoder and its
            # cross-attention (serving, training) at phase 21a's shapes and
            # at batch 2, a ragged Sq = Skv = 1500 over a group of 2, and
            # Sq > Skv; whisper-base's causal decoder self-attention
            # (serving, training: a group of 1); then pixtral-12b's causal
            # prefill (phase 21b)
            ("whisper-base encoder, non-causal", *FA_WH_ENC, False, 0, 0.0),
            ("whisper-base cross, serving, non-causal Sq < Skv",
             *FA_WH_CROSS, False, 0, 0.0),
            ("whisper-base cross, training, non-causal Sq < Skv",
             *FA_WH_CROSS_TRAIN, False, 0, 0.0),
            ("whisper-base encoder at batch 2, non-causal", 2,
             *FA_WH_ENC[1:], False, 0, 0.0),
            ("whisper-base cross at batch 2, non-causal Sq < Skv", 2,
             *FA_WH_CROSS[1:], False, 0, 0.0),
            ("ragged non-causal Sq = Skv = 1500, GQA 8 over 4", 1, 1500,
             1500, 8, 4, 64, False, 0, 0.0),
            ("non-causal Sq > Skv", 1, 90, 33, 4, 2, 64, False, 0, 0.0),
            ("whisper-base decoder, serving, causal, group 1", *FA_WH_DEC,
             True, 0, 0.0),
            ("whisper-base decoder, training, causal, group 1",
             *FA_WH_DEC_TRAIN, True, 0, 0.0),
            ("pixtral-12b prefill, 32 over 8, hd 128", FA_PX[0], FA_PX[1],
             *FA_PX[1:], True, 0, 0.0),
            # phase 25's prefills: yi-9b's group of 8 and
            # command-r-plus-104b's 96 query heads over 8, at head dim 128
            (f"{YI_ARCH} prefill, 32 over 4, hd 128", *FA_YI[:2],
             *FA_YI[1:], True, 0, 0.0),
            (f"{CR_ARCH} prefill, 96 over 8, hd 128", *FA_CR[:2],
             *FA_CR[1:], True, 0, 0.0),
            # phase 23b's per-chip slice of llama3.2-1b's train_4k: 4096
            # keys in one batch row, the backward split 2 with the group sum
            ("llama3.2-1b train_4k per-chip slice, 32 over 8",
             *FA_SLICE[:2], *FA_SLICE[1:], True, 0, 0.0))


def fa_inputs(g, b, sq, skv, h, kvh, hd, dtype):
    shape = lambda s, n: (b, s, n, hd)  # noqa: E731
    return [torch.randn(shape(sq, h), device="cuda", generator=g).to(dtype),
            torch.randn(shape(skv, kvh), device="cuda", generator=g).to(dtype),
            torch.randn(shape(skv, kvh), device="cuda", generator=g).to(dtype)]


def ent_inputs(g, b, v, kind, dtype):
    """Logits of three kinds: 3 x N(0, 1) (as the reference's tests),
    peaked (one logit at 100) and uniform (all zero); labels at random."""
    if kind == "peaked":
        logits = torch.zeros((b, v), device="cuda")
        logits[:, 7] = 100.0
    elif kind == "uniform":
        logits = torch.zeros((b, v), device="cuda")
    else:
        logits = torch.randn((b, v), device="cuda", generator=g) * 3
    labels = torch.randint(0, v, (b,), device="cuda", dtype=torch.int32,
                           generator=g)
    return logits.to(dtype), labels


def score_kernel_parity():
    """flash_attention and entropy_scores against their plain versions on
    the card, float32 and bfloat16: the largest absolute difference in
    float32 (the serve path's type) per kernel. flash_attention's cases
    with keys past one KV_CHUNK are also held to the model's
    ``chunked_attention`` (the reference's scan over key chunks) within
    the same limits."""
    from repro_torch.kernels.entropy_scores import ops as ent
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import attention as attn
    g = torch.Generator(device="cuda").manual_seed(4)
    errs = {"flash_attention": 0.0, "entropy_scores": 0.0}
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    for label, b, sq, skv, h, kvh, hd, causal, window, cap in FA_CASES:
        for dtype, tol in tols.items():
            q, k, v = fa_inputs(g, b, sq, skv, h, kvh, hd, dtype)
            if 0 < cap < 10:
                q = q * FA_CAP_QS
            kw = dict(causal=causal, window=window, softcap=cap)
            out = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            plain = fa.reference(q, k, v, **kw)
            err = within_tol([out.float()], [plain.float()], tol)
            lse_text = ""
            if skv > attn.KV_CHUNK:
                qp = torch.arange(skv - sq, skv, device="cuda").expand(b, sq)
                kp = torch.arange(skv, device="cuda").expand(b, skv)
                c_err = within_tol([out.float()], [attn.chunked_attention(
                    q, k, v, qp, kp, **kw).float()], tol)
                chunks = -(-skv // attn.KV_CHUNK)
                lse_text = (f"; against chunked_attention ({chunks} chunks "
                            f"of {attn.KV_CHUNK} keys) {c_err:.3e}")
            if cap or not causal:  # the row log-sum-exp (the backward's
                # input) where it is new: capped and non-causal
                _, lse = fa.forward_with_lse(q, k, v, **kw)
                lse_err = within_tol([lse], [fa.reference_lse(q, k, v, **kw)],
                                     tol)
                lse_text += f"; lse max abs diff {lse_err:.3e}"
                if cap:
                    lg, ok = fa._logits(q, k, causal, window, 1 / hd ** 0.5)
                    top = float(torch.where(ok, lg, 0.0).abs().max())
                    del lg
                    lse_text += f"; uncapped logits up to {top:.1f}"
                del lse
            if dtype == torch.float32:
                lse_text += forward_f64_text(q, k, v, out, plain, kw, label)
                errs["flash_attention"] = max(errs["flash_attention"], err)
                for prefix, entry in FA_ENTRIES:
                    if label.startswith(prefix):
                        key = f"flash_attention@{entry}"
                        errs[key] = max(errs.get(key, 0.0), err)
            log(f"parity flash_attention [{label}] B={b} Sq={sq} Skv={skv} "
                f"H={h} KV={kvh} hd={hd} causal={causal} window={window} "
                f"softcap={cap} {str(dtype)[6:]}: max abs diff {err:.3e}"
                f"{lse_text} (limit {tol} relative and absolute)")
            del q, k, v, out, plain
    errs["flash_attention@deepseek"] = mla_kernel_parity(g, tols)
    log(f"parity flash_attention: the float64 gate took "
        f"{FA_F64_CLOCK['seconds']:.2f}s of phase 3 over "
        f"{FA_F64_CLOCK['cases']} float32 cases (float64 plain route, one "
        f"batch row at a time; the float32 plain output reused)")
    for b, v, kind, label in ((*ENT_PATH, "normal", "serve decode step"),
                              (*ENT_GK, "normal", f"{GK_ARCH} decode step"),
                              (*ENT_DS, "normal", f"{DS_ARCH} decode step"),
                              (*ENT_WH, "normal",
                               f"{WH_ARCH} decode step, scalar loads"),
                              (*ENT_SC, "normal", f"{SC_ARCH} decode step"),
                              (*ENT_MB, "normal", f"{MB_ARCH} decode step"),
                              (*ENT_HY, "normal",
                               f"{HY_ARCH} decode step, scalar loads"),
                              (*ENT_YI, "normal", f"{YI_ARCH} decode step"),
                              (*ENT_CR, "normal", f"{CR_ARCH} decode step"),
                              (*ENT_LARGE, "normal", "large scorer shape"),
                              (132, 128_256, "normal", "132 rows, 2 spans"),
                              (5, 5001, "normal", "V=5001, scalar loads"),
                              (3, 128_257, "normal", "V=128,257"),
                              (4, 4096, "peaked", "peaked"),
                              (4, 4096, "uniform", "uniform")):
        for dtype, tol in tols.items():
            if b * v > 8 * 128_256 and dtype != torch.float32:
                continue
            splits, width = ent.split_columns(b, v)
            logits, labels = ent_inputs(g, b, v, kind, dtype)
            out = ent.entropy_nll(logits, labels)
            torch.cuda.synchronize()
            err = within_tol(out, ent.reference(logits, labels), tol)
            if dtype == torch.float32:
                errs["entropy_scores"] = max(errs["entropy_scores"], err)
            log(f"parity entropy_scores [{label}] B={b} V={v} "
                f"{str(dtype)[6:]} ({splits} spans of {width}): entropy and "
                f"nll max abs diff {err:.3e} (limit {tol} relative and "
                f"absolute)")
    return errs


# (label, B, Sq, Skv, H, q/k head dim, v head dim) of flash_attention at
# unequal head dims (MLA), causal: deepseek-v2's prefill, ragged Sq < Skv,
# rows with no key, the reduced config's pair
FA_MLA_CASES = (("deepseek-v2 prefill", FA_DS[0], FA_DS[1], *FA_DS[1:]),
                ("ragged Sq < Skv", 1, 200, 333, 16, 192, 128),
                ("Sq > Skv: rows with no key", 1, 40, 24, 4, 192, 128),
                ("reduced deepseek pair, ragged", 2, 100, 100, 4, 24, 16))
FA_MLA_LONG = (1, 1300, 16)  # B, S, H past one MLA_CHUNK of latents


def mla_kernel_parity(g, tols):
    """flash_attention at MLA's unequal head dims against its plain version
    (output and row log-sum-exp; float32 2e-5, bfloat16 2e-2) at
    FA_MLA_CASES, and at FA_MLA_LONG against the model's
    ``_mla_attend_latent_chunked`` (the reference's latent-chunked scan)
    on the same latents, expanded as ``mla_forward_expanded`` expands
    them (the backward at these pairs: ``flash_backward_parity``).
    Returns the largest float32 difference."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import attention as attn
    worst = 0.0
    for label, b, sq, skv, h, hd, hd_v in FA_MLA_CASES:
        for dtype, tol in tols.items():
            shapes = ((b, sq, h, hd), (b, skv, h, hd), (b, skv, h, hd_v))
            q, k, v = (torch.randn(x, device="cuda", generator=g).to(dtype)
                       for x in shapes)
            kw = dict(causal=True, scale=hd ** -0.5)
            out, lse = fa.forward_with_lse(q, k, v, **kw)
            torch.cuda.synchronize()
            plain = fa.reference(q, k, v, **kw)
            err = within_tol([out.float()], [plain.float()], tol)
            lse_err = within_tol([lse], [fa.reference_lse(q, k, v, **kw)],
                                 tol)
            f64_text = ""
            if dtype == torch.float32:
                worst = max(worst, err)
                f64_text = forward_f64_text(q, k, v, out, plain, kw, label)
            log(f"parity flash_attention [MLA {label}] B={b} Sq={sq} "
                f"Skv={skv} H={h} hd={hd} hd_v={hd_v} causal "
                f"{str(dtype)[6:]}: out {tuple(out.shape)} max abs diff "
                f"{err:.3e}, lse {lse_err:.3e} (limit {tol} relative and "
                f"absolute){f64_text}")
            del q, k, v, out, lse, plain
    cfg = configs.get_config(DS_ARCH)
    b, s, h = FA_MLA_LONG
    r, nope = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    q = torch.randn((b, s, h, nope + cfg.qk_rope_head_dim), device="cuda",
                    generator=g)
    ckv = torch.randn((b, s, r), device="cuda", generator=g)
    kr = torch.randn((b, s, cfg.qk_rope_head_dim), device="cuda", generator=g)
    wkb = torch.randn((r, h, nope + cfg.v_head_dim), device="cuda",
                      generator=g) / r ** 0.5
    kv = torch.einsum("bsr,rhk->bshk", ckv, wkb)
    k = torch.cat([kv[..., :nope], kr[:, :, None].expand(b, s, h, -1)], -1)
    scale = q.shape[-1] ** -0.5
    out = fa.flash_attention(q, k, kv[..., nope:], causal=True, scale=scale)
    pos = torch.arange(s, device="cuda").expand(b, s)
    want = attn._mla_attend_latent_chunked(q, ckv, kr, wkb, pos, cfg,
                                           causal=True, scale=scale)
    err = within_tol([out], [want], tols[torch.float32])
    worst = max(worst, err)
    log(f"parity flash_attention [MLA past one latent chunk] B={b} S={s} "
        f"H={h} hd={q.shape[-1]} hd_v={cfg.v_head_dim} causal float32: "
        f"against _mla_attend_latent_chunked ({-(-s // attn.MLA_CHUNK)} "
        f"chunks of {attn.MLA_CHUNK} latents, the tail padded) max abs diff "
        f"{err:.3e} (limit 2e-05 relative and absolute)")
    return worst


# seconds phase 3 spends in forward_f64_text, and its cases
FA_F64_CLOCK = {"seconds": 0.0, "cases": 0}


def forward_f64_text(q, k, v, out, plain, kw, label):
    """The float32 forward's output ``out`` and the float32 plain
    version's ``plain``, each's distance from the float64 plain version
    (``forward_gap``), as text; the kernel's may be at most FA_F64_RATIO
    times the plain version's. Its seconds go into FA_F64_CLOCK."""
    t0 = time.perf_counter()
    kern, plain = forward_gap(q, k, v, out, kw, plain)
    FA_F64_CLOCK["seconds"] += time.perf_counter() - t0
    FA_F64_CLOCK["cases"] += 1
    ratio = kern / max(plain, 1e-300)
    if ratio > FA_F64_RATIO:
        raise AssertionError(f"flash_attention's float32 output lies "
                             f"{ratio:.3g} times as far from the float64 "
                             f"plain version as the float32 plain version "
                             f"[{label}]")
    return (f"; from the float64 plain version (over its largest "
            f"magnitude): kernel {kern:.3e}, float32 plain {plain:.3e}, "
            f"kernel / plain {ratio:.3g} (limit {FA_F64_RATIO:g})")


def fa_uncapped_check(out, smi):
    """The uncapped flash_attention launches (CAP = false) against the
    medians FA_RECORDED holds at the llama3.2-1b, starcoder2-3b and
    hymba-1.5b shapes: on a card at their 700 W (the power limit read
    from ``smi``) the median must stay within the recorded max plus 5%
    (medians on four cards of one kind spread by 1.8% at the llama3.2-1b
    shape; the capped code path costs 9-46% at these shapes); at another
    power limit it is logged alone."""
    limit_w = smi.rsplit(",", 1)[-1].split()[0]
    gate = abs(float(limit_w) - 700.0) < 0.5
    for key, (med, lo, hi) in FA_RECORDED.items():
        t = out[key]
        log(f"timing {key} uncapped beside its record: {t['ms']:.4f} ms "
            f"[{t['lo']:.4f}-{t['hi']:.4f}] against {med:.4f} [{lo:.4f}-"
            f"{hi:.4f}]; limit {1.05 * hi:.4f} ms "
            f"{'(a 700 W card)' if gate else f'not applied: {limit_w} W'}")
        if gate and t["ms"] > 1.05 * hi:
            raise AssertionError(f"{key}: the uncapped kernel's {t['ms']:.4f}"
                                 f" ms is beyond its recorded spread")


def flex_softcap(qt, kt, vt, cap):
    """``torch.nn.attention.flex_attention`` (compiled, as it must be to
    run fused; the port never calls it) with a ``score_mod`` of
    cap * tanh(s / cap), a causal block mask and grouped heads, as a call
    on (B, heads, S, hd) tensors ``qt``, ``kt`` and ``vt``."""
    # inductor's and Triton's caches go into the checkout's build tree
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    s = qt.shape[2]

    def capped(score, b, h, q_idx, kv_idx):
        return torch.tanh(score / cap) * cap

    def causal(b, h, q_idx, kv_idx):
        return q_idx >= kv_idx

    mask = create_block_mask(causal, None, None, s, s, device=qt.device)
    flex = torch.compile(flex_attention)
    return lambda: flex(qt, kt, vt, score_mod=capped, block_mask=mask,
                        enable_gqa=True)


def flex_softcap_ms(q, k, v, cap):
    """The library yardstick of the soft-capped kernel: one call of
    ``flex_softcap`` on (B, heads, S, hd) copies of q, k and v (causal,
    every row with a visible key). Its output is held once to
    ``ops.reference(softcap=cap)`` within 2e-5 relative and absolute.
    Returns its ms (CUDA events, mean of 10 calls) and its largest
    absolute difference."""
    from repro_torch.kernels.flash_attention import ops as fa
    call = flex_softcap(*(x.transpose(1, 2).contiguous() for x in (q, k, v)),
                        cap)
    err = within_tol([call().transpose(1, 2)],
                     [fa.reference(q, k, v, softcap=cap)], 2e-5)
    return cuda_ms(call, 10), err


def score_kernel_timings(smi):
    """flash_attention at the serve paths' prefill shapes (llama3.2-1b and
    starcoder2-3b causal at head dims 64 and 128, hymba-1.5b under its
    1024-token window, grok-1-314b's with its logits capped at 30 and
    without the cap) and entropy_scores at their decode shapes (and a
    large scorer shape): device ms (profiler; median of WINDOWS windows,
    with the spread), wrapper ms, plain ms, bound, and the PyTorch call
    that computes the same function as the yardstick (SDPA; for the
    capped shape ``flex_softcap_ms``). The first shape of each kernel
    goes into the kernels line."""
    import torch.nn.functional as F
    from repro_torch.kernels.entropy_scores import ops as ent
    from repro_torch.kernels.flash_attention import ops as fa
    g = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for key, (b, s, h, kvh, hd), window, caps in (
            ("flash_attention", FA_PATH, 0, (0.0,)),
            ("flash_attention@hd128", FA_SC, 0, (0.0,)),
            ("flash_attention@hymba", FA_HY, HY_WINDOW, (0.0,)),
            ("flash_attention@grok", FA_GK, 0, (GK_CAP, 0.0))):
        q, k, v = fa_inputs(g, b, s, s, h, kvh, hd, torch.float32)
        # the library yardstick: SDPA on (B, heads, S, hd), grouped heads;
        # under a window, with the (S, S) boolean mask of the visible keys
        # and K/V copied out to every query head (no mask-taking backend
        # groups heads)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        if window:
            i = torch.arange(s, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                 - window)
            kt, vt = (x.repeat_interleave(h // kvh, dim=1) for x in (kt, vt))
            sdpa = dict(attn_mask=mask)
        else:
            sdpa = dict(is_causal=True, enable_gqa=True)
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **sdpa), 10)
        # visible (query, key) pairs: causal, capped at the window
        vis = np.minimum(np.arange(1, s + 1), window or s)
        pairs = b * h * int(vis.sum())
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
        flops = 4 * hd * pairs  # a multiply-add each for q.k and p.v
        if caps[0]:  # the capped function's own library call
            flex_ms, flex_err = flex_softcap_ms(q, k, v, caps[0])
        for cap in caps:
            name = key if cap == caps[0] else f"{key}-uncapped"
            # the kernel takes each multiply-add as three TF32 products
            # (3xTF32) on the tensor cores; the float32 units' bound is
            # logged beside. A cap adds one tanhf a visible pair on the
            # float32 units, beside the products
            kw = dict(window=window, softcap=cap)
            med, lo, hi, _ = device_ms_windows(
                lambda: fa.flash_attention(q, k, v, **kw), 10, "flash_fwd",
                WINDOWS)
            t = {"ms": med, "lo": lo, "hi": hi,
                 "call_ms": cuda_ms(
                     lambda: fa.flash_attention(q, k, v, **kw), 10),
                 "plain_ms": cuda_ms(lambda: fa.reference(q, k, v, **kw), 3),
                 "library_ms": flex_ms if cap else sdpa_ms,
                 "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                 "ops_ms": 3 * flops / TF32_FLOPS * 1e3,
                 "f32_ms": flops / PEAK_FLOPS[torch.float32] * 1e3}
            t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
            t["bound_by"] = ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                             else "operations")
            out[name] = t
            lib = (f"library_ms {sdpa_ms:.4f} = torch.nn.functional."
                   f"scaled_dot_product_attention({', '.join(sdpa)}) on (B, "
                   f"heads, S, hd) copies, never called by the port" if not cap
                   else f"library_ms {flex_ms:.4f} = torch.nn.attention."
                   f"flex_attention(score_mod=cap*tanh(s/cap), causal "
                   f"block_mask, enable_gqa=True), compiled, on (B, heads, "
                   f"S, hd) copies, never called by the port (max abs diff "
                   f"{flex_err:.3e} against the plain version, limit 2e-5 "
                   f"relative and absolute); SDPA without the cap "
                   f"{sdpa_ms:.4f} ms beside; {pairs:.4g} tanhf beside the "
                   f"products")
            log(f"timing {name} [q ({b}, {s}, {h}, {hd}), k and v ({b}, {s}, "
                f"{kvh}, {hd}) f32, causal, window {window}, softcap {cap}]: "
                f"kernel {med:.4f} ms on the device "
                f"(profiler, median of {WINDOWS} windows of 10 calls; min "
                f"{lo:.4f}, max {hi:.4f}); {t['call_ms']:.4f} ms per wrapper "
                f"call; plain {t['plain_ms']:.4f} ms; bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {flops:.4g} "
                f"operations as 3xTF32 at 495/3 TFLOP/s; {t['f32_ms']:.4f} ms "
                f"at the 67 TFLOP/s of the float32 units; {t['bytes_ms']:.4f} "
                f"ms of bytes); {med / t['bound_ms']:.2f}x its bound; "
                f"{flops / med / 1e9:.2f} TFLOP/s; {lib}")
        del q, k, v, qt, kt, vt, sdpa
    capped, plain = out["flash_attention@grok"], out[
        "flash_attention@grok-uncapped"]
    log(f"timing flash_attention at grok-1's prefill: the cap costs "
        f"{capped['ms'] - plain['ms']:.4f} ms ({capped['ms']:.4f} capped, "
        f"{plain['ms']:.4f} uncapped, medians of {WINDOWS} windows)")
    fa_uncapped_check(out, smi)
    b, s, h, hd, hd_v = FA_DS
    t = out["flash_attention@deepseek"] = fa_launch_timing(
        "flash_attention@deepseek", (b, s, s, h, h, hd), True, smi, g=g,
        hd_v=hd_v, backend=True)
    log(f"timing flash_attention@deepseek: the kernel {t['ms']:.4f} ms "
        f"against SDPA's forward {t['library_ms']:.4f} ms in the same run "
        f"(limit: below it); {smi}")
    if t["ms"] >= t["library_ms"]:
        raise AssertionError(f"flash_attention@deepseek: the forward's "
                             f"{t['ms']:.4f} ms is not below SDPA's "
                             f"{t['library_ms']:.4f} ms")
    fwd_launch_info()
    out.update(encdec_kernel_timings(g, smi))
    for key, (b, v) in (("entropy_scores", ENT_PATH),
                        ("entropy_scores@grok", ENT_GK),
                        ("entropy_scores@deepseek", ENT_DS),
                        ("entropy_scores@whisper", ENT_WH),
                        ("entropy_scores@starcoder2", ENT_SC),
                        ("entropy_scores@mamba2", ENT_MB),
                        ("entropy_scores@hymba", ENT_HY),
                        (f"entropy_scores@{YI_ARCH}", ENT_YI),
                        (f"entropy_scores@{CR_ARCH}", ENT_CR),
                        ("entropy_scores@large", ENT_LARGE)):
        logits, labels = ent_inputs(g, b, v, "normal", torch.float32)
        lab64 = labels.long()
        nbytes = 4 * b * v + 4 * b + 8 * b
        flops = 5 * b * v  # compare, subtract, exp, add, multiply-add
        med, lo, hi, parts = device_ms_windows(
            lambda: ent.entropy_nll(logits, labels), 50,
            ("entropy_nll_part", "entropy_nll_merge"), WINDOWS)
        t = {"ms": med,
             "call_ms": cuda_ms(lambda: ent.entropy_nll(logits, labels), 50),
             "plain_ms": cuda_ms(lambda: ent.reference(logits, labels), 5),
             "library_ms": cuda_ms(lambda: F.cross_entropy(
                 logits, lab64, reduction="none"), 20),
             "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "ops_ms": flops / PEAK_FLOPS[torch.float32] * 1e3}
        t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
        t["bound_by"] = ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                         else "operations")
        out[key] = t
        splits, width = ent.split_columns(b, v)
        passes = ", ".join(f"{k} {x:.4f}" for k, x in parts.items())
        log(f"timing {key} [logits ({b}, {v}) f32, {splits} spans of "
            f"{width}]: kernel {med:.4f} ms on the device (profiler, both "
            f"passes, median of {WINDOWS} windows of 50 calls; min {lo:.4f}, "
            f"max {hi:.4f}; medians {passes}); {t['call_ms']:.4f} ms per "
            f"wrapper call; plain "
            f"{t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}); library_ms {t['library_ms']:.4f} = "
            f"torch.nn.functional.cross_entropy(reduction='none'), which "
            f"computes the NLL half alone, never called by the port")
        if key == "entropy_scores":  # 4.1 MB of logits: they stay in L2
            flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
            cmed, clo, chi, cparts = device_ms_windows(
                l2_cold(lambda: ent.entropy_nll(logits, labels), flush), 50,
                ("entropy_nll_part", "entropy_nll_merge"), WINDOWS)
            passes = ", ".join(f"{k} {x:.4f}" for k, x in cparts.items())
            log(f"timing {key} L2-cold [logits ({b}, {v}) f32]: kernel "
                f"{cmed:.4f} ms on the device (profiler, both passes, "
                f"{L2_FLUSH_BYTES >> 20} MiB written before each call, the "
                f"kernel's own records alone; median of {WINDOWS} windows "
                f"of 50 calls; min {clo:.4f}, max {chi:.4f}; medians "
                f"{passes}); {t['bound_ms'] / cmed:.0%} of its bound "
                f"{t['bound_ms']:.4f} ms (L2-warm {med:.4f} ms)")
            del flush
        del logits, labels, lab64
    return out


def fwd_launch_info():
    """Each flash_fwd instantiation's registers, shared memory and blocks
    an SM (``ops.forward_info``), logged; its shared memory and the
    library's flash_attention_smem_bytes (phase 2's log line) must both be
    the bytes ``ops.forward_smem`` reckons (ops' mirror of the compiled
    layout)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    smem = build.library("flash_attention").flash_attention_smem_bytes
    for hd, hd_v in fa.HEAD_DIMS:
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            want = fa.forward_smem(hd, hd_v, dtype)
            caps = (False, True) if hd == hd_v else (False,)
            infos = [fa.forward_info(hd, dtype, hd_v, cap) for cap in caps]
            log(f"forward launches [hd {hd}, hd_v {hd_v}, "
                f"{str(dtype)[6:]}; {fa.FWD_LAYOUTS[hd]} (keys a tile, "
                f"stages, TMA slots)]: " + "; ".join(
                    f"{'capped' if cap else 'uncapped'} {r} registers, {m} "
                    f"bytes of shared memory, {n} blocks an SM"
                    for cap, (r, m, n) in zip(caps, infos))
                + f"; forward_smem {want}")
            if smem(hd, hd_v, code) != want or any(m != want
                                                   for _, m, _ in infos):
                raise AssertionError(f"flash_fwd at ({hd}, {hd_v}) "
                                     f"{dtype}: shared memory differs from "
                                     f"ops.forward_smem's {want}")


def visible_pairs(b, sq, skv, h, causal):
    """(query, key) pairs a launch's masks leave visible, no window: every
    pair when non-causal; causal, query row i at position i + Skv - Sq
    sees the keys up to it."""
    if not causal:
        return b * h * sq * skv
    pos = np.arange(sq) + (skv - sq)
    return b * h * int(np.clip(pos + 1, 0, skv).sum())


def fa_launch_timing(key, shape, causal, smi, backward=False, g=None,
                     hd_v=None, backend=False, softcap=0.0):
    """One flash_attention launch shape (B, Sq, Skv, H, KV, hd), float32,
    no window, the default scale 1/sqrt(hd), v of head dim ``hd_v`` (hd
    unless given), logits capped at ``softcap`` (> 0): the forward
    (``flash_fwd``) or, with ``backward``, every launch of a backward call
    under backward_plan: device ms (profiler, median of WINDOWS windows,
    with the spread, and each launch's median), wrapper ms, plain ms, the
    bound (the forward's two products, the backward's five, a multiply-add
    each a visible pair as 3xTF32: S, dQ and dK over hd, dP and dV over
    hd_v; bytes: each input read and each output written once; a cap's
    tanhf, one a visible pair in the forward and in each of the
    backward's two launches, logged beside), and the library yardstick on
    (B, heads, S, hd) copies with the same mask and scale: SDPA
    (``is_causal``, ``enable_gqa``) or, capped, ``flex_softcap``; its
    forward, or its forward plus backward less its forward; ``backend``
    names the backend SDPA's dispatcher takes for the forward."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    b, sq, skv, h, kvh, hd = shape
    hd_v = hd_v or hd
    q, k, v = fa_inputs(g, b, sq, skv, h, kvh, hd, torch.float32)
    if hd_v != hd:
        v = torch.randn((b, skv, kvh, hd_v), device="cuda", generator=g)
    pairs = visible_pairs(b, sq, skv, h, causal)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if softcap:
        lib = flex_softcap(qt, kt, vt, softcap)
        lib_name = (f"torch.nn.attention.flex_attention(score_mod="
                    f"{softcap:g}*tanh(s/{softcap:g}), causal block_mask, "
                    f"enable_gqa=True), compiled")
    else:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        lib_name = (f"torch.nn.functional.scaled_dot_product_attention("
                    f"is_causal={causal}, enable_gqa=True)")
    lib_text = ""
    if backend:
        from torch.nn.attention import SDPBackend
        lib_text = ", backend " + SDPBackend(torch._fused_sdp_choice(
            qt, kt, vt, None, 0.0, causal)).name
    reps = 5 if pairs > 5e8 else 10
    kw = dict(causal=causal, softcap=softcap)
    if backward:
        dout = torch.randn((b, sq, h, hd_v), device="cuda", generator=g)
        o, lse = fa.forward_with_lse(q, k, v, **kw)
        plan = fa.backward_plan(b, h, kvh, sq, skv, hd, hd_v)
        call = lambda: fa.backward(q, k, v, o, lse, dout,  # noqa: E731
                                   **kw)
        plain = lambda: fa.reference_backward(  # noqa: E731
            q, k, v, o, lse, dout, **kw)
        names = bwd_launch_names(plan)
        for x in (qt, kt, vt):
            x.requires_grad_(True)
        dt = dout.transpose(1, 2).contiguous()
        fwd_bwd = cuda_ms(lambda: torch.autograd.grad(lib(), (qt, kt, vt),
                                                      dt), reps)
        fwd = cuda_ms(lib, reps)
        library = fwd_bwd - fwd
        flops = 2 * (3 * hd + 2 * hd_v) * pairs  # S, dQ, dK; dP, dV
        nbytes = 4 * (2 * q.numel() + 2 * b * sq * h * hd_v
                      + 2 * k.numel() + 2 * v.numel()
                      + lse.numel())  # q, dQ; o, dO; k, dK; v, dV; lse
        tanhf = 2 * pairs
        what = (f"backward (plan: {bwd_layout_text(plan)}, "
                f"{plan['blocks']} dK/dV blocks, "
                f"{plan['scratch_bytes']} bytes of partials)")
        lib_text = (f"forward plus backward {fwd_bwd:.4f} less its forward "
                    f"{fwd:.4f}{lib_text}")
    else:
        call = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
        plain = lambda: fa.reference(q, k, v, **kw)  # noqa: E731
        names = "flash_fwd"
        library = cuda_ms(lib, reps)
        flops = 2 * (hd + hd_v) * pairs  # S = Q K^T, P V
        nbytes = 4 * (q.numel() + k.numel() + v.numel()
                      + b * sq * h * hd_v)
        tanhf = pairs
        what, lib_text = "forward", "forward" + lib_text
    med, lo, hi, parts = device_ms_windows(call, reps, names, WINDOWS)
    t = {"ms": med, "lo": lo, "hi": hi, "call_ms": cuda_ms(call, reps),
         "plain_ms": cuda_ms(plain, 2), "library_ms": library,
         "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
         # every product runs as 3xTF32 on the tensor cores, the card's
         # fastest rate for float32 products at this accuracy; the float32
         # units' time is logged beside it
         "ops_ms": 3 * flops / TF32_FLOPS * 1e3,
         "f32_ms": flops / PEAK_FLOPS[torch.float32] * 1e3}
    t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
    t["bound_by"] = ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                     else "operations")
    each = ", ".join(f"{n} {x:.4f}" for n, x in parts.items())
    cap_text = (f"; softcap {softcap:g}: {tanhf:.4g} tanhf beside the "
                f"products, on the float32 units" if softcap else "")
    log(f"timing {key} [{what}; q ({b}, {sq}, {h}, {hd}), k ({b}, {skv}, "
        f"{kvh}, {hd}), v ({b}, {skv}, {kvh}, {hd_v}) f32, causal={causal}, "
        f"no window, scale 1/sqrt({hd})]: kernel "
        f"{med:.4f} ms on the device (profiler, median of {WINDOWS} windows "
        f"of {reps} calls; min {lo:.4f}, max {hi:.4f}; medians {each}); "
        f"{t['call_ms']:.4f} ms per wrapper call; plain {t['plain_ms']:.4f} "
        f"ms; bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {pairs:.4g} "
        f"visible pairs, {flops:.4g} operations as 3xTF32 at 495/3 "
        f"TFLOP/s; {t['f32_ms']:.4f} ms at the 67 TFLOP/s of the float32 "
        f"units; {nbytes / 1e9:.4g} GB in {t['bytes_ms']:.4f} ms"
        f"{cap_text}); {med / t['bound_ms']:.2f}x its bound; "
        f"{flops / med / 1e9:.2f} TFLOP/s; library_ms {library:.4f} = "
        f"{lib_name} {lib_text} on (B, heads, S, hd) copies, never called "
        f"by the port; {smi}")
    return t


def encdec_kernel_timings(g, smi):
    """flash_attention at phase 21's launches: whisper-base's encoder
    self-attention and its cross-attention at serving, forward, and the
    encoder's and the cross-attention's backward at training (every pair
    visible: non-causal, no window), pixtral-12b's causal prefill and
    phase 25's (yi-9b's, command-r-plus-104b's), under their kernels-line
    names."""
    return {
        "flash_attention@whisper-encoder": fa_launch_timing(
            "flash_attention@whisper-encoder", FA_WH_ENC, False, smi, g=g),
        "flash_attention@whisper-cross": fa_launch_timing(
            "flash_attention@whisper-cross", FA_WH_CROSS, False, smi, g=g),
        "flash_attention_bwd@whisper-encoder": fa_launch_timing(
            "flash_attention_bwd@whisper-encoder", FA_WH_ENC, False, smi,
            backward=True, g=g),
        "flash_attention_bwd@whisper-cross": fa_launch_timing(
            "flash_attention_bwd@whisper-cross", FA_WH_CROSS_TRAIN, False,
            smi, backward=True, g=g),
        "flash_attention@pixtral-12b": fa_launch_timing(
            "flash_attention@pixtral-12b", (FA_PX[0], FA_PX[1], *FA_PX[1:]),
            True, smi, g=g),
        # phase 25's prefills
        f"flash_attention@{YI_ARCH}": fa_launch_timing(
            f"flash_attention@{YI_ARCH}", (*FA_YI[:2], *FA_YI[1:]), True,
            smi, g=g),
        f"flash_attention@{CR_ARCH}": fa_launch_timing(
            f"flash_attention@{CR_ARCH}", (*FA_CR[:2], *FA_CR[1:]), True,
            smi, g=g)}


# flash_attention's backward at the seams beyond FA_CASES (label, B, Sq,
# Skv, H, KV, hd, causal, window): groups of 1, 4 and 12, head dims 16
# to 128, Sq and Skv off multiples of 64, batch 1, windows, and Sq > Skv
# with rows whose keys are all masked. At batch 1 and one or two KV heads
# backward_plan splits every group of more than one head.
FA_BWD_SEAMS = (
    ("g 1, hd 16, Sq > Skv: rows with no key", 1, 90, 33, 4, 4, 16, True, 0),
    ("g 4, hd 32, window 7, Sq > Skv", 1, 90, 33, 8, 2, 32, True, 7),
    ("g 12, hd 16, non-causal, window 9", 1, 77, 77, 12, 1, 16, False, 9),
    ("g 12, hd 128, ragged", 1, 130, 130, 24, 2, 128, True, 0),
    ("g 4, hd 128, Sq > Skv: rows with no key", 1, 70, 24, 4, 1, 128, True,
     0),
    ("g 1, hd 64, Sq < Skv, window 50, batch 2", 2, 100, 257, 4, 4, 64, True,
     50),
    ("g 4, hd 32, non-causal, Sq < Skv", 1, 65, 129, 8, 2, 32, False, 0),
    ("g 12, KV 1, batch 1", 1, 200, 200, 12, 1, 64, True, 0),
    ("g 12, KV 2, batch 1, hd 128", 1, 256, 256, 24, 2, 128, True, 0),
    ("g 12, hd 128, ragged Skv > Sq", 1, 100, 333, 12, 1, 128, True, 0))
# grids backward_plan leaves unsplit, with long dK/dV sums in one block:
# 8 heads of 4096 queries at head dim 64, 6 heads of 2048 at 128
FA_BWD_LONG = (
    ("g 8, 4096 keys, batch 9", 9, 4096, 4096, 8, 1, 64, True, 0),
    ("g 6, 2048 keys, batch 9, hd 128", 9, 2048, 2048, 24, 4, 128, True, 0))


def bwd_layout_text(plan):
    """A backward plan's two launch layouts and split, as text."""
    return "; ".join(
        f"{n}: {plan[n]['rows']} rows a block, {plan[n]['tile_rows']}-row "
        f"tiles, {plan[n]['stages']} stages, {plan[n]['smem_bytes']} bytes"
        for n in ("dq", "dkdv")) + f"; split {plan['split']}"


def bwd_launch_names(plan):
    """The kernels one backward call launches under ``plan``."""
    return ("flash_bwd_dq", "flash_bwd_dkdv") + (
        ("flash_bwd_group_sum",) if plan["split"] > 1 else ())


# the capped backward beyond FA_CASES' capped cases (label, B, Sq, Skv, H,
# KV, hd, causal, window, softcap): the capped build at head dim 32
FA_BWD_CAPPED = (
    ("GQA 8 over 2, ragged, cap 5 biting, hd 32", 1, 130, 130, 8, 2, 32,
     True, 0, 5.0),
    ("non-causal, cap 2, hd 32", 1, 96, 96, 4, 4, 32, False, 0, 2.0))
# the backward at MLA's head-dim pairs (label, B, Sq, Skv, H, KV, hd,
# hd_v, causal, window), K and V per head as MLA expands them:
# deepseek-v2-236b's training launch (phase 22a's), ragged Sq < Skv, rows
# with no key, a window; the reduced config's (24, 16), also grouped (4
# heads over 1 KV head, which backward_plan splits) and non-causal
FA_BWD_MLA = (
    ("deepseek-v2 training", *FA_DS[:2], FA_DS[1], FA_DS[2], FA_DS[2],
     *FA_DS[3:], True, 0),
    ("(192, 128) ragged Sq < Skv", 1, 200, 333, 16, 16, 192, 128, True, 0),
    ("(192, 128) Sq > Skv: rows with no key", 1, 40, 24, 4, 4, 192, 128,
     True, 0),
    ("(192, 128) window 100, ragged", 2, 300, 300, 8, 8, 192, 128, True,
     100),
    ("(24, 16) reduced deepseek-v2, ragged", 2, 100, 100, 4, 4, 24, 16, True,
     0),
    ("(24, 16) Sq > Skv, window 7", 1, 90, 33, 4, 4, 24, 16, True, 7),
    ("(24, 16) 4 over 1, group split", 1, 130, 130, 4, 1, 24, 16, True, 0),
    ("(24, 16) non-causal Sq < Skv", 1, 65, 129, 4, 4, 24, 16, False, 0))


def bwd_inputs(g, b, sq, skv, h, kvh, hd, hd_v, dtype, q_scale=1.0):
    """q (times ``q_scale``), k, v and dO from ``g``: v and dO at head dim
    ``hd_v``."""
    q, k, v, dout = (torch.randn(shape, device="cuda", generator=g)
                     for shape in ((b, sq, h, hd), (b, skv, kvh, hd),
                                   (b, skv, kvh, hd_v), (b, sq, h, hd_v)))
    return (q * q_scale).to(dtype), k.to(dtype), v.to(dtype), dout.to(dtype)


def plain_routes(q, k, v, dout, kw):
    """The float64 plain route's gradients (reference, reference_lse,
    reference_backward on float64 copies) and the float32 plain route's
    on the same inputs, one batch row at a time: ([dq, dk, dv] float64,
    [dq, dk, dv] float32)."""
    from repro_torch.kernels.flash_attention import ops as fa
    g64, g32 = [[], [], []], [[], [], []]
    for i in range(q.shape[0]):
        for xs, out in (([x[i:i + 1].double() for x in (q, k, v, dout)],
                         g64),
                        ([x[i:i + 1] for x in (q, k, v, dout)], g32)):
            o = fa.reference(*xs[:3], **kw)
            got = fa.reference_backward(
                *xs[:3], o, fa.reference_lse(*xs[:3], **kw), xs[3], **kw)
            for j in range(3):
                out[j].append(got[j])
            del o, got
    return [torch.cat(x) for x in g64], [torch.cat(x) for x in g32]


def f64_gap(got, g64):
    """How far gradients ``got`` (dq, dk, dv) lie from the float64 plain
    route's ``g64``: for each, the largest absolute difference over the
    float64 gradient's largest magnitude; then the key-bias residue, the
    largest |sum of dk over the keys| of a batch row, KV head and dim
    over dk's largest float64 magnitude. The key bias's exact gradient is
    0 (each row of dS sums to 0), so the residue is sum_q delta_q q, delta_q
    the rounding left in row q's sum of dS."""
    out = [float((a.double() - w).abs().max() / max(float(w.abs().max()),
                                                    1e-300))
           for a, w in zip(got, g64)]
    out.append(float(got[1].double().sum(dim=1).abs().max())
               / max(float(g64[1].abs().max()), 1e-300))
    return out


def f64_text_of(gap, cap, spec=".3e"):
    """``f64_gap``'s four numbers as text; the residue only uncapped (under
    a soft-cap dS takes 1 - t^2, so its rows need not sum to 0 and the key
    bias's exact gradient is not 0)."""
    text = ", ".join(format(x, spec) for x in gap[:3])
    return text + (f"; {format(gap[3], spec)}" if not cap else
                   "; (capped: no residue)")


def f64_distances(q, k, v, dout, got, kw):
    """``f64_gap`` of the kernel route's gradients ``got`` (its forward's
    output and lse, its backward) and of the float32 plain route's
    (reference, reference_lse, reference_backward) on the same inputs:
    (kernel's, float32 plain's), each [dq, dk, dv, key-bias residue]."""
    g64, g32 = plain_routes(q, k, v, dout, kw)
    return f64_gap(got, g64), f64_gap(g32, g64)


# FA_CASES beside the capped and MLA ones whose float32 backward is held to
# the float64 plain route: llama3.2-1b's (17b's) launch and whisper-base's
# encoder and cross-attention (serving and training shapes)
FA_F64_LABELS = ("serve prefill", "whisper-base encoder, non-causal",
                 "whisper-base cross, serving, non-causal Sq < Skv",
                 "whisper-base cross, training, non-causal Sq < Skv")
# the float32 kernel route's distance from the float64 plain route may be
# at most this multiple of the float32 plain route's, for dq, dk and dv
FA_F64_RATIO = 3.0


def flash_backward_parity():
    """flash_attention's backward and the forward's row log-sum-exp against
    reference_backward and reference_lse on the card, float32 (1e-4 of
    each plain gradient's largest magnitude; the lse within 2e-5 relative
    and absolute) and bfloat16 (2e-2), under backward_plan (FA_CASES,
    capped ones included, with q scaled by FA_CAP_QS under a cap below
    10, FA_BWD_SEAMS, FA_BWD_LONG, FA_BWD_CAPPED and FA_BWD_MLA), a
    second call bit-equal to the first. At the capped and MLA cases and
    FA_F64_LABELS, the float32 kernel route's and plain route's distances
    from the float64 plain route (``f64_distances``) and their key-bias
    residues are logged beside, and the kernel route's distance must be
    at most FA_F64_RATIO times the plain route's for each of dq, dk and
    dv. Returns the largest
    absolute difference of a float32 gradient: every case's, and those of
    the kernels line's entries (FA_ENTRIES' whisper-base cases, grok-1's
    capped prefill shape, deepseek-v2's training shape)."""
    from repro_torch.kernels.flash_attention import ops as fa
    g = torch.Generator(device="cuda").manual_seed(6)
    worst, errs = 0.0, {}
    entries = (*FA_ENTRIES[:2], ("grok-1 prefill", GK_ARCH),
               ("deepseek-v2 training", DS_ARCH))
    cases = ([(c[0], *c[1:7], c[6], *c[7:]) for c in FA_CASES]
             + [(*c[:7], c[6], *c[7:], 0.0) for c in FA_BWD_SEAMS
                + FA_BWD_LONG]
             + [(*c[:7], c[6], *c[7:]) for c in FA_BWD_CAPPED]
             + [(*c, 0.0) for c in FA_BWD_MLA])
    for (label, b, sq, skv, h, kvh, hd, hd_v, causal, window,
         cap) in cases:
        new = bool(cap) or hd != hd_v or label in FA_F64_LABELS
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v, dout = bwd_inputs(g, b, sq, skv, h, kvh, hd, hd_v,
                                       dtype, FA_CAP_QS if 0 < cap < 10
                                       else 1.0)
            kw = dict(causal=causal, window=window, softcap=cap)
            out, lse = fa.forward_with_lse(q, k, v, **kw)
            want = fa.reference_backward(q, k, v, out, lse, dout, **kw)
            lse_err = within_tol([lse], [fa.reference_lse(q, k, v, **kw)],
                                 2e-5)
            plan = fa.backward_plan(b, h, kvh, sq, skv, hd, hd_v, dtype)
            got = fa.backward(q, k, v, out, lse, dout, **kw)
            torch.cuda.synchronize()
            rel, diff = [], 0.0
            for a, r in zip(got, want):
                if a.shape != r.shape or a.dtype != r.dtype:
                    raise AssertionError(f"backward shape/dtype {a.shape} "
                                         f"{a.dtype} vs {r.shape} {r.dtype}")
                d = float((a.float() - r.float()).abs().max())
                top = float(r.float().abs().max())
                rel.append(d / top if top else d)
                diff = max(diff, d)
            del want
            again = fa.backward(q, k, v, out, lse, dout, **kw)
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            del again
            f64_text, ratios = "", [0.0]
            if new and dtype == torch.float32:
                kern, plain = f64_distances(q, k, v, dout, got, kw)
                ratios = [a / max(b, 1e-300) for a, b in zip(kern, plain)]
                f64_text = (f"; from the float64 plain route (dq, dk, dv "
                            f"over its largest magnitude; the key-bias "
                            f"residue): kernel route "
                            f"{f64_text_of(kern, cap)}, float32 plain "
                            f"route {f64_text_of(plain, cap)}; kernel / "
                            f"plain {f64_text_of(ratios, cap, '.3g')} "
                            f"(limit {FA_F64_RATIO:g} on dq, dk, dv)")
            log(f"parity flash_attention_bwd [{label}] B={b} Sq={sq} "
                f"Skv={skv} H={h} KV={kvh} hd={hd} hd_v={hd_v} "
                f"causal={causal} window={window} softcap={cap} "
                f"{str(dtype)[6:]}, {bwd_layout_text(plan)}: dq, dk, dv "
                f"max abs diff over the largest "
                f"magnitude {rel[0]:.3e}, {rel[1]:.3e}, {rel[2]:.3e} (limit "
                f"{tol}); max abs diff {diff:.3e}; lse {lse_err:.3e}; a "
                f"second call bit-equal {same}{f64_text}")
            if max(rel) > tol or not same:
                raise AssertionError(f"flash_attention's backward differs "
                                     f"from reference_backward or from "
                                     f"itself [{label}, {dtype}]")
            if max(ratios[:3]) > FA_F64_RATIO:
                raise AssertionError(f"flash_attention's float32 backward "
                                     f"lies {max(ratios[:3]):.3g} times as "
                                     f"far from the float64 plain route as "
                                     f"the float32 plain route [{label}]")
            if dtype == torch.float32:
                worst = max(worst, diff)
                for prefix, entry in entries:
                    if label.startswith(prefix):
                        key = f"flash_attention_bwd@{entry}"
                        errs[key] = max(errs.get(key, 0.0), diff)
            del q, k, v, dout, out, lse, got
    return {"flash_attention_bwd": worst, **errs}


def bwd_launch_info(plan, hd, hd_v, cap):
    """``backward_info``'s registers, shared memory and blocks an SM of
    each float32 backward launch, as text; the dq and dK/dV launches'
    shared memory must be the bytes ``backward_plan`` reckons (ops'
    mirror of the compiled layout)."""
    from repro_torch.kernels.flash_attention import ops as fa
    info = fa.backward_info(hd, torch.float32, hd_v, bool(cap))
    for name, launch in (("flash_bwd_dq", "dq"), ("flash_bwd_dkdv", "dkdv")):
        if info[name][1] != plan[launch]["smem_bytes"]:
            raise AssertionError(f"{name} takes {info[name][1]} bytes of "
                                 f"shared memory, backward_plan reckons "
                                 f"{plan[launch]['smem_bytes']}")
    return "; ".join(f"{n} {r} registers, {m} bytes of shared memory, "
                     f"{n_sm} blocks an SM"
                     for n, (r, m, n_sm) in info.items())


def flash_backward_timings(smi):
    """flash_attention's backward at both serve shapes, causal, through
    ``fa_launch_timing`` (every launch of a call under backward_plan
    beside SDPA's backward, which it must beat), and at phase 22's
    full-width launches, grok-1-314b's capped at 30 (beside
    ``flex_softcap``'s backward) and deepseek-v2-236b's at head dims
    (192, 128) (beside SDPA's, its backend named, which it must beat too),
    with the launches' registers, shared memory and blocks an SM
    (``bwd_launch_info``); then the forward with the row log-sum-exp
    written beside without it, windows in turns. The first shape and the
    two full-width ones go into the kernels line."""
    from repro_torch.kernels.flash_attention import ops as fa
    g = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for key, (b, s, h, kvh, hd) in (("flash_attention_bwd", FA_PATH),
                                    ("flash_attention_bwd@hd128", FA_SC)):
        t = out[key] = fa_launch_timing(key, (b, s, s, h, kvh, hd), True,
                                        smi, backward=True, g=g)
        plan = fa.backward_plan(b, h, kvh, s, s, hd)
        log(f"backward launches [{bwd_layout_text(plan)}; hd {hd} f32]: "
            f"{bwd_launch_info(plan, hd, hd, 0.0)}")
        if t["ms"] >= t["library_ms"]:
            raise AssertionError(f"{key}: the backward's {t['ms']:.4f} ms is "
                                 f"not below SDPA's backward "
                                 f"{t['library_ms']:.4f} ms")
    for key, (b, s, h, kvh, hd), hd_v, cap in (
            (f"flash_attention_bwd@{GK_ARCH}", FA_GK, FA_GK[4], GK_CAP),
            (f"flash_attention_bwd@{DS_ARCH}",
             (*FA_DS[:2], FA_DS[2], FA_DS[2], FA_DS[3]), FA_DS[4], 0.0)):
        t = out[key] = fa_launch_timing(key, (b, s, s, h, kvh, hd), True,
                                        smi, backward=True, g=g, hd_v=hd_v,
                                        backend=not cap, softcap=cap)
        plan = fa.backward_plan(b, h, kvh, s, s, hd, hd_v)
        log(f"backward launches [{bwd_layout_text(plan)}; hd {hd}, hd_v "
            f"{hd_v}, softcap {cap:g}, f32]: "
            f"{bwd_launch_info(plan, hd, hd_v, cap)}")
        if not cap and t["ms"] >= t["library_ms"]:
            raise AssertionError(f"{key}: the backward's {t['ms']:.4f} ms is "
                                 f"not below SDPA's backward "
                                 f"{t['library_ms']:.4f} ms")
    # the forward with the log-sum-exp written against without it,
    # windows in turns (off, on, on, off, ...)
    b, s, h, kvh, hd = FA_PATH
    q, k, v = fa_inputs(g, b, s, s, h, kvh, hd, torch.float32)
    runs = {False: [], True: []}
    for i in range(2 * WINDOWS):
        with_lse = (i % 4) in (1, 2)
        fn = ((lambda: fa.forward_with_lse(q, k, v)) if with_lse
              else (lambda: fa.flash_attention(q, k, v)))
        runs[with_lse].append(device_ms(fn, 10, "flash_fwd"))
    off, on = (sorted(runs[x]) for x in (False, True))
    m_off, m_on = statistics.median(off), statistics.median(on)
    slack = max(off[-1] - off[0], 0.01 * m_off)
    log(f"timing flash_attention forward with the row log-sum-exp "
        f"written: {m_on:.4f} ms (min {on[0]:.4f}, max {on[-1]:.4f}) "
        f"beside {m_off:.4f} ms without (min {off[0]:.4f}, max "
        f"{off[-1]:.4f}); {WINDOWS} profiled windows of 10 calls "
        f"each, in turns; limit {m_off + slack:.4f} ms (the spread "
        f"without, or 1%)")
    if m_on > m_off + slack:
        raise AssertionError("writing the log-sum-exp slows the "
                             "forward beyond its spread")
    return out


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------

def fleet_cost_arrays(rng, m, n_docs, k):
    """Per-stream 3-tier (hot/warm/cold) cost arrays of
    examples/million_streams.py: write-cheap read-expensive hot tier, the
    reverse cold, jittered per stream."""
    jit = lambda lo, hi: rng.uniform(lo, hi, m)  # noqa: E731
    cw = np.stack([jit(0.8, 1.2) * 1e-6, jit(0.8, 1.2) * 2e-5,
                   jit(0.8, 1.2) * 8e-5], axis=1)
    cr = np.stack([jit(0.8, 1.2) * 2.7e-4, jit(0.8, 1.2) * 4e-5,
                   jit(0.8, 1.2) * 1e-6], axis=1)
    cs = np.stack([jit(0.8, 1.2) * 2.5e-6, jit(0.8, 1.2) * 1e-6,
                   jit(0.8, 1.2) * 2.5e-7], axis=1)
    return (cw, cr, cs, np.full(m, float(n_docs)), np.full(m, float(k)),
            rng.uniform(0.5, 4.0, m))


def eval_plan(args, bounds, mig):
    """The float64 plan objective at given (bounds, migrate), with the
    planner's conventions (the reference's tests/test_plan_device.py)."""
    from repro_torch.core import shp
    cw, cr, cs, n, k, rpw = args
    m, t = cw.shape
    edges = np.concatenate([np.zeros((m, 1)), bounds, n[:, None]], 1)
    frac = np.diff(edges, axis=1) / n[:, None]
    writes = (np.diff(shp._w_approx(edges, k[:, None]), axis=1) * cw).sum(1)
    reads = rpw * k * (frac * cr).sum(1)
    tot_nm = writes + reads + k * np.max(np.where(frac > 0, cs, -np.inf), 1)
    fee = np.zeros(m)
    prev = np.zeros(m, np.int64)
    usedm = np.concatenate([frac[:, :-1] > 0, np.ones((m, 1), bool)], 1)
    crossing = usedm[:, 1:] & np.logical_or.accumulate(usedm, 1)[:, :-1]
    for ti in range(1, t):
        fee = fee + np.where(crossing[:, ti - 1],
                             cr[np.arange(m), prev] + cw[:, ti], 0.0)
        prev = np.where(usedm[:, ti], ti, prev)
    return np.where(mig, writes + k * (frac * cs).sum(1) + k * fee, tot_nm)


def check_f32_plan(label, args, ref, got):
    """The reference's float32 rule: the device plan re-evaluates within
    1e-5 of the oracle's optimum; reported totals within 5e-3."""
    tot_err = float(np.max(np.abs(got["total"] / ref["total"] - 1)))
    subopt = float(np.max(np.abs(
        eval_plan(args, got["bounds"], got["migrate"]) / ref["total"] - 1)))
    log(f"{label}: float32 device plan vs the NumPy oracle: totals within "
        f"{tot_err:.3e} relative (limit 5e-3), re-evaluated suboptimality "
        f"{subopt:.3e} (limit 1e-5)")
    if not (tot_err < 5e-3 and subopt < 1e-5):
        raise AssertionError(f"{label}: float32 plan off the oracle")


def check_f64_plan(label, args, ref, got):
    """The reference's float64 rule: feasibility and migrate equal,
    infeasible bounds zeroed, totals within 1e-11 relative, bounds equal
    or re-evaluating to the oracle's total within 1e-11."""
    feas = np.isfinite(ref["total"])
    rel = float(np.max(np.abs(got["total"][feas] / ref["total"][feas] - 1),
                       initial=0.0))
    moved = feas & ~(got["bounds"] == ref["bounds"]).all(axis=1)
    re_ev = eval_plan(args, got["bounds"], got["migrate"])
    rel_b = float(np.max(np.abs(re_ev[moved] / ref["total"][moved] - 1),
                         initial=0.0))
    ok = (np.array_equal(np.isfinite(got["total"]), feas)
          and np.array_equal(got["migrate"], ref["migrate"])
          and (got["bounds"][~feas] == 0).all() and rel <= 1e-11
          and rel_b <= 1e-11)
    log(f"{label}: float64 device plan vs the NumPy oracle: {int(feas.sum())}"
        f" feasible, feasibility and migrate equal: {ok}; totals within "
        f"{rel:.3e} relative, {int(moved.sum())} plans with other bounds "
        f"re-evaluate within {rel_b:.3e} (limit 1e-11)")
    if not ok:
        raise AssertionError(f"{label}: float64 plan off the oracle")


def plan_fleet(rng, hot_frac=0.6):
    """The example's plan on the card: closed-form solve, fleet-shared
    hot-tier budget water-filled, binding streams re-solved under their
    grant — through shp.plan_ntier_arrays, whose "auto" rule takes the
    device planner here. Both solves are then held to the NumPy oracle
    on the same fleet."""
    from repro_torch.core import constraints as cons
    from repro_torch.core import shp
    from repro_torch.kernels.plan_solve import ops as ps
    from repro_torch.streams import planner
    args = fleet_cost_arrays(rng, M, DOCS, K)
    cw, cr, cs, n, kv, rpw = args
    # the counted run: counter to 0, plan, read
    ps.launches = 0
    t0 = time.perf_counter()
    plan = shp.plan_ntier_arrays(*args)
    t_solve = time.perf_counter() - t0
    n_solve = ps.launches
    bounds, mig = plan["bounds"].copy(), plan["migrate"].copy()
    desired = cons.peak_occupancy_arrays(bounds, n, kv, mig)[:, 0]
    budget = float(desired.sum()) * hot_frac
    grants = planner.waterfill(desired, budget)
    idx = np.flatnonzero(grants < desired - 1e-9)
    sub = tuple(a[idx] for a in args)
    cap = np.full((idx.size, 3), np.inf)
    cap[:, 0] = grants[idx]
    t0 = time.perf_counter()
    re = shp.plan_ntier_arrays(*sub, cap=cap)
    t_resolve = time.perf_counter() - t0
    launches = ps.launches
    log(f"plan launches: plan_solve {n_solve} in the solve, "
        f"{launches - n_solve} in the re-solve")
    if n_solve != 4 or launches != 8:
        raise AssertionError(f"the plan missed plan_solve: {n_solve}, "
                             f"{launches}")
    bounds[idx], mig[idx] = re["bounds"], re["migrate"]
    hot = cons.peak_occupancy_arrays(bounds, n, kv, mig)[:, 0].sum()
    if not hot <= budget * (1 + 1e-9) + 1e-6:
        raise AssertionError("hot-tier budget oversubscribed")
    t0 = time.perf_counter()
    host = shp.plan_ntier_arrays(*args, backend="numpy")
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_re = shp.plan_ntier_arrays(*sub, cap=cap, backend="numpy")
    t_host_re = time.perf_counter() - t0
    log(f"plan: {M} streams, 3 tiers on the card: solve {t_solve:.3f}s "
        f"(NumPy oracle {t_host:.3f}s), constrained re-solve of {idx.size} "
        f"binding streams {t_resolve:.3f}s (NumPy oracle {t_host_re:.3f}s); "
        f"hot peak {hot:.0f} <= budget {budget:.0f}; {int(mig.sum())} "
        f"migrating")
    check_f32_plan("plan", args, host, plan)
    check_f64_plan("re-solve", sub, host_re, re)
    plan_profile(args)
    # what phase 16's sharded plan is held to, bit for bit
    plan5 = {"args": args, "plan": plan, "re": re, "idx": idx, "cap": cap,
             "budget": budget, "n_solve": n_solve,
             "n_resolve": launches - n_solve}
    return bounds, mig, launches, plan5


def plan_profile(args):
    """torch.profiler over one more unconstrained solve of the fleet: its
    wall time, the device's busy share, and the top device operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import shp
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        shp.plan_ntier_arrays(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = union_ms(dev)
    log(f"plan profile: {M}-stream solve: wall {wall_ms:.3f} ms (profiler "
        f"on); device busy {busy:.3f} ms = {busy / wall_ms:.3f} of wall; "
        f"{len(dev)} device operations")
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in ops[:8]:
        log(f"plan profile: {e.self_device_time_total / 1e3:9.4f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


def window_chunks(rng, window, n_chunks=DOCS // CHUNK):
    """The ingest_dense-shaped chunks of one window, made on the host
    before any clock starts (doc ids continue across windows)."""
    out = []
    for c in range(n_chunks):
        lo = window * DOCS + c * CHUNK
        ids = np.tile(np.arange(lo, lo + CHUNK, dtype=np.int32), (M, 1))
        out.append([(rng.standard_normal((M, CHUNK), dtype=np.float32),
                     ids)])
    return out


def check_sample(eng, sample, trace, bounds, mig, tiers=None):
    """Survivors of the sampled streams against independent simulator
    replays of their traces; with ``tiers`` (finalize_tiers' output),
    the tiers of statically placed streams against the policy too."""
    from repro_torch.core import placement, simulator
    ids = eng.states()[0].ids[torch.as_tensor(sample, device=eng.device)]
    ids = ids.cpu().numpy()
    bad = 0
    for j, row in enumerate(sample):
        pol = placement.Policy(boundaries=tuple(bounds[row]),
                               migrate_at_r=bool(mig[row]))
        sim = simulator.simulate(trace[j].astype(np.float64), K, pol)
        ok = np.array_equal(np.sort(ids[j][ids[j] >= 0]), sim.survivor_ids)
        if ok and tiers is not None and not mig[row]:
            t_row = tiers[int(row)]
            ok = [pol.tier_of(int(d)) for d in t_row["ids"]] == \
                t_row["tiers"].tolist()
        bad += not ok
    log(f"main path: {len(sample) - bad}/{len(sample)} sampled streams "
        f"bit-match their simulator replay over {trace.shape[1]} docs")
    if bad:
        raise AssertionError("main path diverged from simulator replays")


def main_path():
    from repro_torch.kernels.batched_topk import ops as btk
    from repro_torch.kernels.tier_assign import ops as ta
    from repro_torch.streams import StreamEngine, StreamSpec
    rng = np.random.default_rng(0)
    bounds, mig, ps_launches, plan5 = plan_fleet(rng)
    t0 = time.perf_counter()
    eng = StreamEngine([StreamSpec(stream_id=i, k=K, boundaries=tuple(b),
                                   migrate=bool(g))
                        for i, (b, g) in enumerate(zip(bounds.tolist(),
                                                       mig.tolist()))])
    log(f"engine: built for {M} streams on {eng.device} in "
        f"{time.perf_counter() - t0:.3f}s")
    first = window_chunks(rng, 0)
    n_chunks = len(first)

    # the counted run: counters to 0, drive, read
    btk.launches = ta.launches = 0
    t0 = time.perf_counter()
    done = eng.ingest_chunks(first, meter=False)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiers = eng.finalize_tiers()
    t_fin = time.perf_counter() - t0
    launches = {"batched_topk": btk.launches, "tier_assign": ta.launches}
    log(f"main-path launches: {launches}")
    launches["plan_solve"] = ps_launches
    t0 = time.perf_counter()
    eng.assign_tiers()
    torch.cuda.synchronize()
    log(f"assign_tiers (floor copy and tier_assign, no per-stream dict): "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms for {M} streams")
    if launches["batched_topk"] != n_chunks or launches["tier_assign"] < 1:
        raise AssertionError(f"main path missed a kernel: {launches}")
    docs = M * CHUNK * done
    log(f"ingest, first window (warm-up): {done} chunks, {docs} docs in "
        f"{t_first:.4f}s = {docs / t_first:.6g} docs/s")
    log(f"finalize_tiers: {t_fin:.3f}s for {M} streams (assign_tiers plus "
        f"the per-stream result dict)")

    counts = np.stack([tiers[i]["counts"] for i in range(M)])
    if int(counts.sum()) != M * K:
        raise AssertionError(f"per-tier counts sum {counts.sum()} != M*K")
    log(f"finalize_tiers: counts sum {int(counts.sum())} = M*K; per tier "
        f"{counts.sum(0).tolist()}")

    # 256 sampled streams against independent simulator replays, after
    # the counted window and again after the timed ones (the double
    # buffer in steady state)
    sample = np.sort(rng.choice(M, 256, replace=False))
    trace = np.concatenate([ch[0][0][sample] for ch in first], axis=1)
    check_sample(eng, sample, trace, bounds, mig, tiers)

    rates = []
    for w in range(1, TIMED_WINDOWS + 1):
        chunks = window_chunks(rng, w)
        trace = np.concatenate([trace] + [ch[0][0][sample] for ch in chunks],
                               axis=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.ingest_chunks(chunks, meter=False)
        torch.cuda.synchronize()
        rates.append(M * CHUNK * len(chunks) / (time.perf_counter() - t0))
    log(f"ingest, {TIMED_WINDOWS} windows after the warm-up: median "
        f"{statistics.median(rates):.6g} docs/s, min {min(rates):.6g}, "
        f"max {max(rates):.6g} (16 chunks of {M} x {CHUNK} per window, "
        f"host-made chunks; host clock around ingest_chunks and a sync)")
    check_sample(eng, sample, trace, bounds, mig)
    rate = {"first": docs / t_first, "median": statistics.median(rates)}
    return eng, launches, rng, (bounds, mig, rate, plan5)


# ---------------------------------------------------------------------------
# phase 6: metered self-check
# ---------------------------------------------------------------------------

def example(name):
    """The module of examples_torch/<name>.py."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def self_check():
    """examples_torch/multi_tenant_streams.py's run() at its defaults
    (1024 tenants, 256 docs, batches of 32, seed 0): its fleet, its
    shuffled ingest and its replay check, then its engine's launches and
    finalize_tiers against the meter's attribution."""
    from repro_torch.kernels.batched_topk import ops as btk
    from repro_torch.kernels.tier_assign import ops as ta
    script = example("multi_tenant_streams")
    args = script.parse_args([])
    m, docs, batch = args.streams, args.docs, args.batch
    # the counted run: counters to 0, drive, read after finalize_tiers
    btk.launches = ta.launches = 0
    res = script.run(args)
    eng, t_ingest, match = res.engine, res.ingest_s, res.matched
    tiers = eng.finalize_tiers()
    launches = {"batched_topk": btk.launches, "tier_assign": ta.launches}
    n_buckets = len(eng.buckets)
    # every router-fed batch is W=32 >= K wide, so each bucket's step
    # takes filtered_update (batched_topk); finalize_tiers runs one
    # tier_assign per bucket
    want = {"batched_topk": docs // batch * n_buckets,
            "tier_assign": n_buckets}
    log(f"self-check launches: {launches} ({docs // batch} steps x "
        f"{n_buckets} buckets)")
    if launches != want:
        raise AssertionError(f"self-check launches {launches} != {want}")
    agree = 0
    for sid, out in tiers.items():
        row = eng.stream_row(sid)
        valid = out["ids"] >= 0
        host = eng.meter._effective_tier(np.array([row]),
                                         out["ids"][None])[0]
        agree += (np.array_equal(out["tiers"][valid], host[valid])
                  and np.array_equal(out["counts"], eng.meter.reads[row]))
    rec = eng.meter.reconcile(batch=batch)
    log(f"self-check: {m} tenants, K in (4, 8, 16, 32), metered ingest "
        f"{t_ingest:.3f}s; bit-match {match}/{m} simulator replays; "
        f"finalize_tiers == meter attribution {agree}/{m}; writes actual "
        f"{rec['fleet_actual']:.0f} expected {rec['fleet_expected']:.1f}")
    if match != m or agree != m:
        raise AssertionError("self-check failed")


# ---------------------------------------------------------------------------
# phase 7: step profile
# ---------------------------------------------------------------------------

def union_ms(events):
    """Length of the union of the events' time ranges, in ms."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):  # microseconds
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def step_profile(eng, chunks, label):
    """Profile ``eng.ingest_chunks`` over ``chunks``: wall and device-busy
    time per step, the top device operations, and the host's staging copy
    of one chunk alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    steps = len(chunks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.ingest_chunks(chunks, meter=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    any_ms = union_ms(dev) / steps
    # compute engine alone: the host-to-device staging copies run on the
    # copy engine, overlapped with the steps
    compute_ms = union_ms([e for e in dev if "Memcpy" not in e.name]) / steps
    log(f"step profile: {steps} steps of {label}: wall {wall_ms:.3f} "
        f"ms/step (profiler on); compute busy {compute_ms:.3f} ms/step = "
        f"{compute_ms / wall_ms:.3f} of wall; any engine busy (compute or "
        f"copy) {any_ms:.3f} ms/step = {any_ms / wall_ms:.3f} of wall")
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in ops) or 1.0
    for e in ops[:10]:
        log(f"step profile: {e.self_device_time_total / 1e3 / steps:9.4f} "
            f"ms/step {e.self_device_time_total / total:6.3f}  "
            f"{e.key[:90]}")
    if compute_ms <= 0:
        raise AssertionError("the profile saw no device compute time")
    # the host side of staging one chunk: pageable arrays into pinned memory
    dense = [a for pair in chunks[0] for a in pair]
    pinned = [torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                          pin_memory=True) for a in dense]
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for p, a in zip(pinned, dense):
            p.copy_(torch.from_numpy(a))
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"host staging copy of one chunk ({sum(a.nbytes for a in dense)} "
        f"bytes) into pinned memory: {min(times):.3f} ms (min of 3; "
        f"{torch.get_num_threads()} threads)")


# ---------------------------------------------------------------------------
# phase 8: mixed exact + logmem fleet at full width
# ---------------------------------------------------------------------------

def mixed_window_chunks(rng, window, n_chunks=DOCS // CHUNK):
    """``window_chunks`` plus the logmem bucket's pair in every chunk:
    (64 x 8192) scores, ids continuing across chunks and windows."""
    out = window_chunks(rng, window, n_chunks)
    for c, pairs in enumerate(out):
        lo = (window * DOCS // CHUNK + c) * LM_CHUNK
        pairs.append((
            rng.standard_normal((LM_STREAMS, LM_CHUNK), dtype=np.float32),
            np.tile(np.arange(lo, lo + LM_CHUNK, dtype=np.int32),
                    (LM_STREAMS, 1))))
    return out


def mixed_fleet(bounds, mig, rate5):
    from repro_torch.kernels.batched_topk import ops as btk
    from repro_torch.kernels.logmem_update import ops as lm_ops
    from repro_torch.kernels.tier_assign import ops as ta
    from repro_torch.streams import StreamEngine, StreamSpec, logmem
    rng = np.random.default_rng(1)
    specs = [StreamSpec(stream_id=i, k=K, boundaries=tuple(b),
                        migrate=bool(g))
             for i, (b, g) in enumerate(zip(bounds.tolist(), mig.tolist()))]
    specs += [StreamSpec(stream_id=M + j, k=LM_K, r=float(4 * LM_K),
                         engine="logmem") for j in range(LM_STREAMS)]
    eng = StreamEngine(specs)
    # buckets in (K, backend) order: the chunks' pairs are (exact, logmem)
    lb = 1
    if [b.engine for b in eng.buckets] != ["exact", "logmem"]:
        raise AssertionError(f"unexpected buckets {eng.buckets}")
    first = mixed_window_chunks(rng, 0)
    n_chunks = len(first)
    # keep each step's logmem write mask (the device tensor) for the
    # comparison with the CPU run below
    wrotes = []
    dispatch = eng._dispatch

    def recording(batches):
        out = dispatch(batches)
        wrotes.append(out[0][lb])
        return out

    eng._dispatch = recording
    # the counted run: counters to 0, drive, read
    btk.launches = ta.launches = lm_ops.launches = 0
    t0 = time.perf_counter()
    done = eng.ingest_chunks(first, meter=False)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    tiers = eng.finalize_tiers()
    launches = {"logmem_update": lm_ops.launches,
                "batched_topk": btk.launches, "tier_assign": ta.launches}
    del eng._dispatch
    log(f"mixed fleet launches: {launches}")
    want = {"logmem_update": n_chunks, "batched_topk": n_chunks,
            "tier_assign": 1}
    if launches != want:
        raise AssertionError(f"mixed fleet launches {launches} != {want}")
    exact_st, lm_st = eng.states()
    seen = (int(exact_st.seen.sum()), int(lm_st.seen.sum()))
    want_seen = (M * CHUNK * done, LM_STREAMS * LM_CHUNK * done)
    docs = sum(want_seen)
    if seen != want_seen:
        raise AssertionError(f"docs observed {seen} != {want_seen}")
    if set(tiers) != set(range(M)):
        raise AssertionError("finalize_tiers must hold exactly the exact "
                             "streams")
    counts = sum(int(t["counts"].sum()) for t in tiers.values())
    if counts != M * K:
        raise AssertionError(f"per-tier counts sum {counts} != M*K")
    # the example's law and memory checks
    n_lm = LM_CHUNK * done
    law = float(logmem.expected_admits(np.asarray([n_lm]), LM_K)[0])
    slack = logmem.law_slack(LM_K)
    admit_ratio = float(lm_st.admits.double().mean()) / law
    bps = logmem.state_bytes_per_stream(lm_st)
    exact_bps = logmem.exact_bytes_per_stream(LM_K)
    log(f"mixed fleet: {M} exact streams + {LM_STREAMS} logmem tenants at "
        f"K={LM_K}: docs observed {seen[0]} + {seen[1]} = {docs}; logmem "
        f"admits {admit_ratio:.6f}x the write law ({law:.1f} per tenant "
        f"after {n_lm} docs; budget 3*slack = {3 * slack:.6f}); "
        f"{bps:.0f} B/stream vs {exact_bps:.0f} exact "
        f"({exact_bps / bps:.1f}x leaner)")
    if not abs(admit_ratio - 1.0) <= 3.0 * slack:
        raise AssertionError("logmem admits beyond the slack budget")
    if not exact_bps / bps >= 8.0:
        raise AssertionError("logmem state is not 8x leaner")
    # the 64 tenants against the port's own CPU run of the same chunks:
    # holds the torch epilogue (sorts, gathers, f32 arithmetic) on CUDA
    cpu = logmem.init(LM_STREAMS, device="cpu")
    bad = 0
    for c, pairs in enumerate(first):
        s, i = pairs[lb]
        cpu, wrote = logmem.update(cpu, torch.from_numpy(s),
                                   torch.from_numpy(i), LM_K)
        bad += not torch.equal(wrote, wrotes[c].cpu())
    leaves = [name for name, a, b in zip(logmem.LogmemState._fields, cpu,
                                         lm_st)
              if not torch.equal(a, b.cpu())]
    log(f"mixed fleet: logmem tenants on the card vs the CPU run: "
        f"{len(first) - bad}/{len(first)} chunk write masks equal, "
        f"{9 - len(leaves)}/9 state leaves equal bit for bit")
    if bad or leaves:
        raise AssertionError(f"logmem on the card differs from the CPU: "
                             f"{bad} masks, leaves {leaves}")
    sample = np.sort(rng.choice(M, 256, replace=False))
    trace = np.concatenate([ch[0][0][sample] for ch in first], axis=1)
    check_sample(eng, sample, trace, bounds, mig, tiers)
    rates = []
    for w in range(1, MIXED_TIMED_WINDOWS + 1):
        chunks = mixed_window_chunks(rng, w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.ingest_chunks(chunks, meter=False)
        torch.cuda.synchronize()
        rates.append(docs / (time.perf_counter() - t0))
    log(f"mixed fleet ingest: counted window {docs / t_first:.6g} docs/s, "
        f"{len(rates)} timed window(s) "
        f"{' and '.join(f'{r:.6g}' for r in rates)} docs/s "
        f"({docs} docs per window); phase 5 (exact only, {M * DOCS} docs "
        f"per window): first window {rate5['first']:.6g}, median of "
        f"{TIMED_WINDOWS} timed {rate5['median']:.6g} docs/s")
    step_profile(eng, mixed_window_chunks(rng, 1 + MIXED_TIMED_WINDOWS, 4),
                 f"{M} x {CHUNK} exact + {LM_STREAMS} x {LM_CHUNK} logmem")
    return launches


# ---------------------------------------------------------------------------
# phase 9: huge-K harness
# ---------------------------------------------------------------------------

def huge_k_harness():
    from repro_torch.streams import logmem
    rng = np.random.default_rng(2)
    for k, m, n, chunk in RATIO_SWEEP:
        sc = rng.standard_normal((m, n)).astype(np.float32)
        t0 = time.perf_counter()
        rep = logmem.trace_competitive_ratio(sc, k, chunk)
        dt = time.perf_counter() - t0
        cpu = logmem.trace_competitive_ratio(sc, k, chunk, device="cpu")
        slack = logmem.law_slack(k)
        same = all(np.array_equal(rep[key], cpu[key])
                   for key in ("ratio", "admits", "admit_ratio"))
        lo, hi = np.min(rep["admit_ratio"]), np.max(rep["admit_ratio"])
        log(f"huge-K harness K={k} M={m} n={n} chunk={chunk}: min ratio "
            f"{rep['min_ratio']} (>= {1 - slack}), max c {rep['max_c']} "
            f"(<= {logmem.LAW_SLACK_C}), admit ratio {lo}..{hi} (within "
            f"1 +- {3 * slack}); equal to the CPU run: {same}; {dt:.3f}s "
            f"on the card")
        if not (rep["min_ratio"] >= 1.0 - slack
                and rep["max_c"] <= logmem.LAW_SLACK_C
                and np.abs(rep["admit_ratio"] - 1.0).max() <= 3.0 * slack
                and same):
            raise AssertionError(f"huge-K harness failed at K={k}")


# ---------------------------------------------------------------------------
# phase 10: single-stream filter path
# ---------------------------------------------------------------------------

def single_stream():
    from repro_torch.core import topk
    from repro_torch.kernels.topk_filter import ops as tf
    rng = np.random.default_rng(3)
    n = TF_BATCH * TF_BATCHES
    scores = rng.standard_normal(n, dtype=np.float32)
    dev_s = torch.from_numpy(scores).cuda()
    dev_i = torch.arange(n, dtype=torch.int32, device="cuda")
    st = topk.init(TF_K)
    # the counted run: counter to 0, drive, read
    tf.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(TF_BATCHES):
        sl = slice(b * TF_BATCH, (b + 1) * TF_BATCH)
        st, _ = tf.filter_then_merge(st, dev_s[sl], dev_i[sl])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = tf.launches
    log(f"single-stream launches: topk_filter {launches}")
    if launches != TF_BATCHES:
        raise AssertionError(f"topk_filter launched {launches} times, "
                             f"not {TF_BATCHES}")
    # numpy's top-K of the whole trace, ranked by (-score, id)
    kth = np.partition(scores, n - TF_K)[n - TF_K]
    cand = np.flatnonzero(scores >= kth)
    want = cand[np.lexsort((cand, -scores[cand]))][:TF_K]
    got = st.ids.cpu().numpy()
    ok = np.array_equal(got, want) and np.array_equal(
        st.scores.cpu().numpy(), scores[want])
    log(f"single-stream path: filter_then_merge K={TF_K} over "
        f"{TF_BATCHES} batches of {TF_BATCH}: survivors equal numpy's "
        f"top-{TF_K} of {n} scores: {ok}; {n / dt:.6g} docs/s (device-"
        f"resident batches; host clock and a sync)")
    if not ok:
        raise AssertionError("single-stream survivors differ from numpy")
    single_stream_profile(st, dev_s, dev_i)
    return launches


def single_stream_profile(state, dev_s, dev_i, attempts=3 * WINDOWS):
    """Phase 10's profile: WINDOWS torch.profiler windows of
    TF_WINDOW_BATCHES filter_then_merge batches from the full reservoir
    ``state``. Each window opens with one lead-in batch that is not
    counted: late in a long process the profiler was seen to drop the
    topk_filter records of a profile's first batch (its other kernels
    kept; a lead-in launch of topk_filter alone did not help). Device
    records count from the CPU marker of the counted batches on. Attempt
    i takes batches i * (TF_WINDOW_BATCHES + 1) on (modulo TF_BATCHES),
    so the batches run on in the trace's order and each was last read
    TF_BATCHES batches (256 MB) before: cold, as on the path. A window
    counts only if it holds the kernel's record of every counted batch;
    fails unless WINDOWS of ``attempts`` do. Logs the topk_filter
    kernel's median device time (its own records alone; median of the
    windows' medians [min-max]), the step's other device operations per
    batch and the device's busy share of the counted batches' wall
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels.topk_filter import ops as tf
    plan = tf_plan_text(tf.launch_plan(dev_s[:TF_BATCH]))

    def batch(st, b):
        sl = slice(b % TF_BATCHES * TF_BATCH, (b % TF_BATCHES + 1) * TF_BATCH)
        return tf.filter_then_merge(st, dev_s[sl], dev_i[sl])[0]

    meds, busy, ops = [], [], {}
    for i in range(attempts):
        if len(meds) == WINDOWS:
            break
        b0 = i * (TF_WINDOW_BATCHES + 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            st = batch(state, b0)  # the lead-in
            torch.cuda.synchronize()
            with record_function("counted batches"):
                t0 = time.perf_counter()
                for b in range(b0 + 1, b0 + 1 + TF_WINDOW_BATCHES):
                    st = batch(st, b)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        start = min(e.time_range.start for e in prof.events()
                    if e.name == "counted batches")
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and e.time_range.start >= start
               and e.name != "counted batches"]  # the marker's device span
        kern = [(e.time_range.end - e.time_range.start) / 1e3
                for e in dev if "filter_" in e.name]
        if len(kern) != TF_WINDOW_BATCHES:
            log(f"single-stream profile: attempt {i} held {len(kern)} "
                f"topk_filter records for {TF_WINDOW_BATCHES} batches; "
                f"not counted")
            continue
        meds.append(statistics.median(kern))
        busy.append(union_ms(dev) / wall_ms)
        for e in dev:
            key = e.name[:70]
            ops[key] = ops.get(key, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    if len(meds) < WINDOWS:
        raise AssertionError(f"{len(meds)} of {attempts} profiled windows "
                             f"held every topk_filter record, not "
                             f"{WINDOWS}")
    got = sorted(meds)
    log(f"single-stream profile [{plan}]: topk_filter in filter_then_merge "
        f"{statistics.median(meds):.4f} ms on the device [{got[0]:.4f}-"
        f"{got[-1]:.4f}] (median of {WINDOWS} windows' medians over "
        f"{TF_WINDOW_BATCHES} cold batches, the kernel's own records "
        f"alone); device busy {statistics.median(busy):.3f} of wall "
        f"[{min(busy):.3f}-{max(busy):.3f}] (profiler on)")
    per = WINDOWS * TF_WINDOW_BATCHES
    for key, ms in sorted(ops.items(), key=lambda x: -x[1])[:8]:
        log(f"single-stream profile: {ms / per:9.4f} ms/batch  {key}")


# ---------------------------------------------------------------------------
# phase 11: the score producer at full width
# ---------------------------------------------------------------------------

# the record_function ranges of models.ffn.moe_forward: the profiler gives
# each a device-side span from its first kernel to its last, which
# profile_report reports apart from the operations
MOE_RANGES = ("moe.router", "moe.dispatch", "moe.experts", "moe.combine")
# and those of models.attention's MLA: the expanded form (prefill, with its
# flash_attention launch) and the absorbed form (decode)
MLA_RANGES = ("mla.expanded", "mla.absorbed")


def profile_report(prof, label, steps, wall_ms, smi):
    """Device busy share and top device operations of a profiled window
    of ``steps`` steps that took ``wall_ms`` per step, and the device
    spans of MOE_RANGES and MLA_RANGES with their shares of the busy time
    (with MLA, the flash_attention kernel's share too); returns the
    device's busy ms a step."""
    from torch.autograd import DeviceType
    ranges = MOE_RANGES + MLA_RANGES
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [e for e in dev if e.name in ranges]
    dev = [e for e in dev if e.name not in ranges]
    busy = union_ms(dev) / steps
    log(f"{label} profile: {steps} step(s): wall {wall_ms:.3f} ms/step "
        f"(profiler on); device busy {busy:.3f} ms/step = "
        f"{busy / wall_ms:.3f} of wall; {len(dev) // steps} device "
        f"operations per step; {smi}")
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and e.key not in ranges]
    ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in ops) or 1.0
    for e in ops[:8]:
        log(f"{label} profile: {e.self_device_time_total / 1e3 / steps:9.4f} "
            f"ms/step {e.self_device_time_total / total:6.3f}  {e.key[:90]}")
    parts = {n: sum(e.time_range.end - e.time_range.start for e in spans
                    if e.name == n) / 1e3 / steps for n in ranges}
    moe = sum(parts[n] for n in MOE_RANGES)
    if moe:
        log(f"{label} profile: the MoE's device spans {moe:.4f} ms/step = "
            f"{moe / busy:.3f} of the busy time: " + ", ".join(
                f"{n} {parts[n]:.4f} ms ({parts[n] / busy:.3f})"
                for n in MOE_RANGES))
    mla = sum(parts[n] for n in MLA_RANGES)
    if mla:
        flash = sum(e.self_device_time_total for e in ops
                    if "flash_fwd" in e.key) / 1e3 / steps
        log(f"{label} profile: the MLA attention's device spans {mla:.4f} "
            f"ms/step = {mla / busy:.3f} of the busy time (" + ", ".join(
                f"{n} {parts[n]:.4f} ms" for n in MLA_RANGES)
            + f"); the flash_attention kernel inside them {flash:.4f} "
            f"ms/step = {flash / busy:.3f}")
    if busy <= 0:
        raise AssertionError(f"the {label} profile saw no device time")
    return busy


def serve_profile(params, cfg, prompts, smi, steps=4, extra=None):
    """torch.profiler over one prefill of a batch, then over ``steps``
    decode steps (each: the model, the entropy_scores kernel, argmax):
    wall ms, the device's busy share, the top operations; with MoE layers
    the device spans of the MoE's parts and their share of each window
    (``profile_report``). A model with SSD layers also gets its scan's
    share of the prefill (``ssd_share``) from the first layer's scan
    inputs, captured in the prefill. ``extra``: the batch's other model
    inputs (``frames`` or ``patch_embeds``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import interestingness
    from repro_torch.models import lm
    from repro_torch.models import ssm as ssm_mod
    b, s = prompts.shape
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    extra = extra or {}
    cache = lm.init_cache(cfg, b, s + steps + 1, device=prompts.device,
                          enc_len=enc_len_of(extra))
    scan, captured = ssm_mod.ssd_chunked, []

    def capture(*args, **kw):
        if not captured:
            captured.append((args, kw))
        return scan(*args, **kw)

    ssm_mod.ssd_chunked = capture
    torch.cuda.synchronize()
    try:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, cache = lm.prefill(params, cfg, {"tokens": prompts,
                                                     **extra}, cache)
            tok = torch.argmax(logits, -1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ssm_mod.ssd_chunked = scan
    busy = profile_report(prof, f"{cfg.name} prefill ({b} x {s})", 1,
                          wall_ms, smi)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = lm.decode_step(params, cfg, tok, cache)
            interestingness.entropy_score(logits[:, None])
            tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    profile_report(prof, f"{cfg.name} decode (batch {b})", steps, wall_ms,
                   smi)
    if captured:
        args, kw = captured.pop()
        ssd_share(cfg, args, kw, busy, smi)


def enc_len_of(extra):
    """Encoder positions a cache needs for a batch's ``extra`` inputs."""
    return extra["frames"].shape[1] if "frames" in extra else 0


def attention_layers(cfg):
    return sum(s.count for s in cfg.layers
               if s.mixer in ("attn", "attn_ssm_parallel"))


def ssd_share(cfg, args, kw, prefill_busy_ms, smi, attempts=3):
    """One layer's SSD scan (``ssm.ssd_chunked`` on the inputs the prefill
    gave its first SSD layer) alone: its device ms (CUDA events, the mean
    of 5 calls after two warm-up calls) and its share of the prefill's
    device busy time, taken as the layer count times one scan's ms; then
    its operations by device time under torch.profiler, over a window of
    3 calls. The profiler drops kernel records now and then
    (``device_parts``), so a window that holds none is taken again, up to
    ``attempts`` windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import ssm as ssm_mod
    scan = lambda: ssm_mod.ssd_chunked(*args, **kw)  # noqa: E731
    ms = cuda_ms(scan, 5)
    n = sum(s.count for s in cfg.layers
            if s.mixer in ("ssm", "attn_ssm_parallel"))
    label = (f"{cfg.name} SSD scan (ssm.ssd_chunked, one layer: xh "
             f"{tuple(args[0].shape)}, state {args[1].shape[-1]}, chunk "
             f"{args[5]})")
    log(f"{label}: {ms:.3f} ms on the device (CUDA events, mean of 5 "
        f"calls); share of a prefill: {n} layers x {ms:.3f} ms = "
        f"{n * ms:.3f} ms of the prefill's {prefill_busy_ms:.3f} ms of "
        f"device busy time = {n * ms / prefill_busy_ms:.3f}; {smi}")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for attempt in range(1, attempts + 1):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                scan()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 3
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            profile_report(prof, label, 3, wall_ms, smi)
            return
        log(f"{label} profile: window {attempt} held no device record")
    log(f"{label} profile: the profiler dropped every device record of "
        f"{attempts} windows; its operations are not named this run")


def teacher_forced(params, cfg, prompts, gen, extra=None):
    """The first batch through the kernel route and, fed the kernel
    route's tokens, through the plain route (grouped attention in
    prefill, -sum p log p per step) on the card, ``gen`` tokens each:
    logits and scores held within the stated tolerance, argmax agreement
    printed. The batch carries ``extra`` (its frames or patch
    embeddings) beside its tokens, where there are any."""

    def run(**kw):
        return model_generate(params, cfg, {"tokens": prompts,
                                             **(extra or {})},
                              gen, keep_logits=True, **kw)

    a = run()
    b = run(use_kernel=False, forced=a.tokens)
    d_pre = float((a.logits[0] - b.logits[0]).abs().max())
    d_dec = max(float((x - y).abs().max())
                for x, y in zip(a.logits[1:], b.logits[1:]))
    d_sc = float((a.scores - b.scores).abs().max())
    agree = float((a.tokens == b.tokens).float().mean())
    scale = float(a.logits[0].abs().max())
    log(f"teacher-forced [{cfg.name}], first batch ({prompts.shape[0]} x "
        f"{prompts.shape[1]} prompt tokens, {gen} generated): kernel route "
        f"vs plain route on the card: prefill logits max abs diff "
        f"{d_pre:.3e}, decode logits {d_dec:.3e} (limit 1e-3; logits up to "
        f"{scale:.3f}), scores {d_sc:.3e} (limit 1e-4; scores near "
        f"{float(a.scores.mean()):.4f}); argmax agrees in {agree:.4f} of "
        f"{a.tokens.numel()} steps")
    if not (d_pre <= 1e-3 and d_dec <= 1e-3 and d_sc <= 1e-4):
        raise AssertionError("kernel route differs from the plain route "
                             "beyond the stated tolerance")


def check_serve(res, cfg, run, label, smi):
    """Launch counts of one counted serve run of ``run`` (serve's
    arguments), finite scores of the right shape, and the timing lines."""
    from repro_torch.kernels.entropy_scores import ops as ent
    from repro_torch.kernels.flash_attention import ops as fa
    launches = {"flash_attention": fa.launches,
                "entropy_scores": ent.launches}
    batches = -(-run["requests"] // run["batch"])
    want = {"flash_attention": attention_layers(cfg) * batches,
            "entropy_scores": (run["gen_len"] - 1) * batches}
    log(f"serve [{label}] launches: {launches} (want {want}: one "
        f"flash_attention per attention layer per prefill, one "
        f"entropy_scores per scored decode step)")
    if launches != want:
        raise AssertionError(f"serve [{label}] launches {launches} != "
                             f"{want}")
    n = run["requests"]
    if not (res.scores.shape == (n,) and np.isfinite(res.scores).all()
            and res.tokens.shape == (n, run["gen_len"])
            and ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"serve [{label}]: scores or tokens malformed")
    pre = [x * 1e3 for x in res.prefill_s]
    dec = [x * 1e3 / (run["gen_len"] - 1) for x in res.decode_s]
    gen_tok = n * run["gen_len"] / res.seconds
    log(f"serve [{label}]: {n} requests in {res.seconds:.3f}s: prefill "
        f"ms per batch of {run['batch']} x {run['prompt_len']} median "
        f"{statistics.median(pre):.3f} (min {min(pre):.3f}, max "
        f"{max(pre):.3f}); decode ms per token step (batch "
        f"{run['batch']}) median {statistics.median(dec):.3f} (min "
        f"{min(dec):.3f}, max {max(dec):.3f}); {res.tokens_per_s:.6g} "
        f"tokens/s (prompt and generated), {gen_tok:.6g} generated "
        f"tokens/s; host clock, device synced at each phase end; {smi}")
    return launches


def score_producer(smi):
    """Phase 11. Returns the launches of flash_attention and entropy_scores
    summed over the two counted serve runs (single tenant, 8 tenants)."""
    from repro_torch import configs
    from repro_torch.core import placement, simulator
    from repro_torch.kernels.entropy_scores import ops as ent
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import serve
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    cfg = configs.get_config(ARCH)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"score producer: {ARCH} full width ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} "
        f"KV heads, head_dim {cfg.head_dim}, vocab {cfg.vocab_size}, "
        f"{cfg.param_dtype}): {lm.param_count(cfg)} parameters drawn on the "
        f"card in {time.perf_counter() - t0:.3f}s; TF32 off for matmul and "
        f"cuDNN; {smi}")
    b, plen = SERVE["batch"], SERVE["prompt_len"]
    first = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, plen)), device="cuda")
    teacher_forced(params, cfg, first, SERVE["gen_len"])
    torch.cuda.reset_peak_memory_stats()
    # the counted runs: counters to 0, serve, read
    fa.launches = ent.launches = 0
    one = serve.serve(cfg, params, tenants=1, device="cuda", **SERVE)
    launches = check_serve(one, cfg, SERVE, "single tenant", smi)
    log(f"serve [single tenant] scores: "
        f"{' '.join(f'{x:.7g}' for x in one.scores)}")
    order = np.lexsort((np.arange(SERVE["requests"]), -one.scores))
    want = sorted(order[:SERVE["topk"]].tolist())
    log(f"serve [single tenant]: curation {one.curator.stats.as_dict()}, "
        f"ledger {one.store.ledger.as_dict()}; retained {one.retained}, "
        f"top-{SERVE['topk']} of the scores (ties to the lower id) {want}")
    if one.retained != want:
        raise AssertionError("retained set is not the top-K of the scores")
    fa.launches = ent.launches = 0
    many = serve.serve(cfg, params, tenants=SERVE_TENANTS, device="cuda",
                       **SERVE)
    for key, n in check_serve(many, cfg, SERVE, f"{SERVE_TENANTS} tenants",
                              smi).items():
        launches[key] += n
    eng, bad = many.engine, 0
    ids = np.arange(SERVE["requests"])
    for t, spec in enumerate(many.specs):
        row = eng.stream_row(t)
        pol = placement.Policy(boundaries=tuple(eng.meter.boundaries[row]),
                               migrate_at_r=bool(eng.meter.migrate[row]))
        trace = many.scores[ids % SERVE_TENANTS == t].astype(np.float64)
        sim = simulator.simulate(trace, spec.k, pol)
        bad += not np.array_equal(many.retained[t], sim.survivor_ids)
    rec = many.reconcile
    log(f"serve [{SERVE_TENANTS} tenants]: survivors of "
        f"{SERVE_TENANTS - bad}/{SERVE_TENANTS} tenants equal their "
        f"core.simulator replay; K per tenant {[s.k for s in many.specs]}; "
        f"writes actual {rec['fleet_actual']:.0f} expected "
        f"{rec['fleet_expected']:.1f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if bad:
        raise AssertionError("tenant survivors differ from simulator "
                             "replays")
    serve_profile(params, cfg, first, smi)
    return launches


def dense_serve(smi, arch, run, layers=None, phase=None):
    """A dense GQA model at full width served on the card (phase 12's
    starcoder2-3b, phase 25's yi-9b and command-r-plus-104b), its depth
    cut to ``layers`` of its identical attn + dense layers where given,
    random weights from a seeded torch.Generator on the card: the first
    batch teacher-forced through both routes, then one counted
    single-tenant serve run of ``run`` whose launches must be exact, the
    retained set against the top-K of the scores, peak memory, then the
    profiles. ``phase`` labels the lines "[phase arch]" and logs the
    depth, the whole model's count and the memory held before the draw.
    Returns the launches."""
    from repro_torch import configs
    from repro_torch.configs.base import LayerSpec
    from repro_torch.kernels.entropy_scores import ops as ent
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import serve
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()  # the previous model's blocks
    held = torch.cuda.memory_allocated() / 2**30
    full = configs.get_config(arch)
    cfg = full if layers is None else full.replace(
        layers=(LayerSpec(count=layers, mixer="attn", ffn="dense"),))
    label = arch if phase is None else f"{phase} {arch}"
    window = cfg.layers[0].windows
    shape = (f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, head_dim "
             f"{cfg.head_dim}, d_ff {cfg.d_ff} {cfg.ffn_act}, vocab "
             f"{cfg.vocab_size}, "
             + (f"window {window[0]}" if window else
                f"RoPE theta {cfg.rope_theta:g}, tied embeddings "
                f"{cfg.tie_embeddings}") + f", {cfg.param_dtype}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    drawn = time.perf_counter() - t0
    if phase is None:
        log(f"serve {arch}: full width ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {shape}): {lm.param_count(cfg)} parameters "
            f"drawn on the card in {drawn:.3f}s; {smi}")
    else:
        log(f"serve [{label}]: full width, {cfg.n_layers} of "
            f"{full.n_layers} identical attn + dense layers (d_model "
            f"{cfg.d_model}, {shape}): {lm.param_count(cfg)} parameters "
            f"(the whole model {lm.param_count(full)}) drawn on the card in "
            f"{drawn:.3f}s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB while "
            f"drawn ({held:.3f} GiB held by earlier phases); TF32 off; "
            f"{smi}")
    b, plen = run["batch"], run["prompt_len"]
    first = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, plen)), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    teacher_forced(params, cfg, first, run["gen_len"])
    log(f"serve [{label}]: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB in the "
        f"teacher-forced check (the plain route's attention included)")
    torch.cuda.reset_peak_memory_stats()
    # the counted run: counters to 0, serve, read
    fa.launches = ent.launches = 0
    res = serve.serve(cfg, params, tenants=1, device="cuda", **run)
    launches = check_serve(res, cfg, run, f"{label}, single tenant", smi)
    order = np.lexsort((np.arange(run["requests"]), -res.scores))
    want = sorted(order[:run["topk"]].tolist())
    log(f"serve [{label}]: scores "
        f"{' '.join(f'{x:.7g}' for x in res.scores)}; retained "
        f"{res.retained}, top-{run['topk']} of the scores (ties to the "
        f"lower id) {want}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if res.retained != want:
        raise AssertionError("retained set is not the top-K of the scores")
    serve_profile(params, cfg, first, smi)
    return launches


def dense_full(smi):
    """Phase 25: yi-9b at full width and depth (25a) and
    command-r-plus-104b at full width cut to CR_LAYERS layers (25b), each
    through ``dense_serve`` at SC_SERVE's run. Returns the launches of
    flash_attention and entropy_scores summed over the two counted serve
    runs, and each one's flash launches under its kernels-line name."""
    launches = {"flash_attention": 0, "entropy_scores": 0}
    for sub, arch, layers in (("25a", YI_ARCH, None),
                              ("25b", CR_ARCH, CR_LAYERS)):
        depth = "and depth" if layers is None else f"{layers} layers"
        with phase_clock(f"{arch} at full width {depth} (phase {sub})"):
            got = dense_serve(smi, arch, SC_SERVE, layers=layers,
                              phase="25")
        launches[f"flash_attention@{arch}"] = got["flash_attention"]
        for key, n in got.items():
            launches[key] += n
    return launches


# ---------------------------------------------------------------------------
# phase 13: drift-aware re-planning at fleet scale
# ---------------------------------------------------------------------------

def two_tier_fleet(rng, m):
    """examples/online_replanning.py's ``make_fleet`` shape at the phase's
    window: hot tier write-cheap / read-expensive, cold tier the reverse,
    costs jittered so every tenant gets its own r*."""
    from repro_torch.core import costs
    wl = costs.WorkloadSpec(n_docs=RP_DOCS, k=RP_K, doc_gb=1e-4,
                            window_months=0.5)
    jit = rng.uniform(0.9, 1.1, (m, 2))
    return [costs.TwoTierCostModel(
        tier_a=costs.TierCosts("hot", put_per_doc=1e-6,
                               get_per_doc=2.7e-4 * float(a),
                               storage_per_gb_month=0.05),
        tier_b=costs.TierCosts("cold", put_per_doc=8e-5 * float(b),
                               get_per_doc=1e-6, storage_per_gb_month=0.02),
        workload=wl) for a, b in jit]


def four_tier_fleet(rng, m):
    """tests/test_constraints.py's random N-tier models at four tiers (each
    tier's put, get and rental 10^U(-8, -3), transfer fees, a random doc
    size and window length), at the phase's window and K."""
    from repro_torch.core import costs, topology
    out = []
    for _ in range(m):
        specs = tuple(
            topology.TierSpec(
                costs.TierCosts(f"t{i}", *(10.0 ** rng.uniform(-8, -3, 3))),
                xfer_in_per_gb=float(10.0 ** rng.uniform(-7, -3)),
                xfer_out_per_gb=float(10.0 ** rng.uniform(-6, -2)))
            for i in range(4))
        wl = costs.WorkloadSpec(n_docs=RP_DOCS, k=RP_K,
                                doc_gb=float(rng.uniform(1e-4, 1.0)),
                                window_months=float(rng.uniform(0.03, 3.0)))
        out.append(topology.TierTopology(tiers=specs).cost_model(wl))
    return out


def rp_constraints(four):
    """13a: a hot tier of 4K docs (examples/online_replanning.py); 13b:
    K/2 docs on tier 1 (a pair cap on a middle tier: plan_solve's masked
    route) and on tier 3 (its folded mask puts +inf in the terms)."""
    from repro_torch.core import constraints as cons
    if four:
        return cons.ConstraintSet(cons.TierCapacity(1, 0.5 * RP_K),
                                  cons.TierCapacity(3, 0.5 * RP_K))
    return cons.ConstraintSet(cons.TierCapacity(0, 4 * RP_K))


class RpChunks:
    """The drifted window as ingest_dense-shaped chunks, made chunk by
    chunk from one seeded generator: doc i scores -E/θ_i in float32 with
    E ~ Exp(1) and θ = 1 before RP_DRIFT_AT, RP_MULT from it on (the law
    of ``core.simulator.drifted_rank_trace``) — on every row, or on the
    rows of ``drifted`` alone (the others keep θ = 1, the law of an
    undrifted trace). The sampled rows' scores are kept; the seconds
    spent making chunks are counted so a rate can leave them out."""

    def __init__(self, seed, m, sample=None, drifted=None):
        from repro_torch.core import simulator
        self.seed, self.m, self.sample = seed, m, sample
        self.drifted = drifted
        self.theta = simulator.drift_weights(
            RP_DOCS, [(RP_DRIFT_AT, RP_MULT)]).astype(np.float32)
        self.kept, self.gen_s = [], 0.0

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        for c0 in range(0, RP_DOCS, RP_CHUNK):
            t0 = time.perf_counter()
            w = min(RP_CHUNK, RP_DOCS - c0)
            theta = self.theta[c0:c0 + w]
            if self.drifted is not None:
                theta = np.where(self.drifted[:, None], theta,
                                 np.float32(1.0))
            sc = (-rng.standard_exponential((self.m, w), dtype=np.float32)
                  / theta)
            if self.sample is not None:
                self.kept.append(sc[self.sample])
            ids = np.broadcast_to(np.arange(c0, c0 + w, dtype=np.int32),
                                  (self.m, w))
            chunk = [(sc, ids)]
            self.gen_s += time.perf_counter() - t0
            yield chunk

    def trace(self, j):
        """Sampled row j's scores over the window, as float64."""
        return np.concatenate([c[j] for c in self.kept]).astype(np.float64)

    def sample_chunks(self):
        """The kept rows' chunks, as the card's run got them."""
        return [[(c, np.broadcast_to(
            np.arange(i * RP_CHUNK, i * RP_CHUNK + c.shape[1],
                      dtype=np.int32), c.shape))]
                for i, c in enumerate(self.kept)]


def timed_replans(eng):
    """Wrap the engine's re-plan hook and solver: one record per chunk
    that flagged streams, (chunk, rows, solve s, whole re-plan s, solve
    plan_solve launches)."""
    from repro_torch.kernels.plan_solve import ops as ps
    records, inner = [], {}
    hook, solve = eng._maybe_replan, eng._replanner.replan
    chunk = [0]

    def timed_solve(rows, *a, **kw):
        p0, t0 = ps.launches, time.perf_counter()
        out = solve(rows, *a, **kw)
        inner.update(rows=len(rows), s=time.perf_counter() - t0,
                     ps=ps.launches - p0)
        return out

    def timed_hook(*args):
        inner.clear()
        t0 = time.perf_counter()
        hook(*args)
        if inner:
            records.append((chunk[0], inner["rows"], inner["s"],
                            time.perf_counter() - t0, inner["ps"]))
        chunk[0] += 1

    eng._maybe_replan, eng._replanner.replan = timed_hook, timed_solve
    return records


def rp_specs(models):
    from repro_torch.streams import StreamSpec
    return [StreamSpec(stream_id=i, k=RP_K, cost_model=cm)
            for i, cm in enumerate(models)]


def rp_config():
    from repro_torch.online import DriftConfig, ReplanConfig
    return ReplanConfig(drift=DriftConfig(alpha=RP_ALPHA))


def replanning_run(label, models, four, seed, rng):
    """One engine with replan= on the card over the drifted window:
    launches, events, re-plan timings, finalize_tiers, constraints."""
    from repro_torch.kernels.batched_topk import ops as btk
    from repro_torch.kernels.plan_solve import ops as ps
    from repro_torch.kernels.tier_assign import ops as ta
    from repro_torch.streams import StreamEngine
    m = len(models)
    sample = np.sort(rng.choice(m, RP_SAMPLE, replace=False))
    chunks = RpChunks(seed, m, sample)
    # the counted run: counters to 0, plan, drive, finalize, read
    btk.launches = ta.launches = ps.launches = 0
    t0 = time.perf_counter()
    eng = StreamEngine(rp_specs(models), constraints=rp_constraints(four),
                       replan=rp_config())
    plan_s, plan_ps = time.perf_counter() - t0, ps.launches
    planned = (eng.meter.boundaries.copy(), eng.meter.migrate.copy())
    records = timed_replans(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_chunks = eng.ingest_chunks(chunks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiers = eng.finalize_tiers()
    fin_s = time.perf_counter() - t0
    launches = {"batched_topk": btk.launches, "tier_assign": ta.launches,
                "plan_solve": ps.launches}
    replan_ps = ps.launches - plan_ps
    evs = eng.replan_events
    docs = m * RP_DOCS
    log(f"re-planning [{label}]: {m} tenants, K={RP_K}, {RP_DOCS} docs "
        f"each in {n_chunks} chunks of {RP_CHUNK} ({docs} docs), "
        f"{RP_MULT:g}x burst at doc {RP_DRIFT_AT}; plan {plan_s:.3f}s; "
        f"launches {launches} (plan_solve: {plan_ps} in the plan, "
        f"{replan_ps} in the re-plans)")
    applied = sum(e.applied for e in evs)
    feasible = sum(e.feasible for e in evs)
    fired = len({e.stream_id for e in evs})
    log(f"re-planning [{label}]: {len(evs)} replan events over {fired} "
        f"tenants, {applied} applied, {feasible} feasible, "
        f"{len(eng.admission_events)} admission events; "
        f"{int(eng.meter.relocations.sum())} residents relocated")
    rows = np.array([r[1] for r in records] or [0])
    solve_s = sum(r[2] for r in records)
    hook_s = sum(r[3] for r in records)
    top = max(records, key=lambda r: r[1]) if records else None
    log(f"re-planning [{label}]: {len(records)} chunks re-planned, "
        f"{int(rows.sum())} flagged rows in all (most {int(rows.max())} "
        f"in one chunk); host seconds in the re-plan hook {hook_s:.3f} "
        f"(solve incl. the device re-solve {solve_s:.3f}, events and "
        f"meter {hook_s - solve_s:.3f}); chunk {top[0] if top else '-'} "
        f"re-planned {top[1] if top else 0} rows in "
        f"{top[3] * 1e3 if top else 0:.3f} ms (solve "
        f"{top[2] * 1e3 if top else 0:.3f} ms, {top[4] if top else 0} "
        f"plan_solve launches)")
    rate = docs / (wall - chunks.gen_s)
    log(f"re-planning [{label}]: ingest {wall:.3f}s, {chunks.gen_s:.3f}s "
        f"of it making chunks on the host: {rate:.6g} docs/s with replan= "
        f"(meter on; host clock around ingest_chunks and a sync, chunk "
        f"making left out); finalize_tiers {fin_s:.3f}s")
    # chunks at least K wide take the bar scan (the last one is narrower)
    wide = sum(min(RP_CHUNK, RP_DOCS - c0) >= RP_K
               for c0 in range(0, RP_DOCS, RP_CHUNK))
    if launches["batched_topk"] != wide or launches["tier_assign"] < 1:
        raise AssertionError(f"re-planning [{label}] missed a kernel: "
                             f"{launches}, {wide} wide chunks")
    if four and replan_ps < 1:
        raise AssertionError("no plan_solve launch inside 13b's re-plans")
    if not applied:
        raise AssertionError(f"re-planning [{label}]: no re-plan applied")
    counts = np.stack([tiers[i]["counts"] for i in range(m)])
    if int(counts.sum()) != m * RP_K:
        raise AssertionError("finalize_tiers counts do not sum to M*K")
    report = eng.check_constraints()
    kinds = sorted({(v["tier"], v["kind"]) for v in report["violations"]})
    log(f"re-planning [{label}]: check_constraints ok={report['ok']} "
        f"({len(report['violations'])} violations, (tier, kind) {kinds})")
    # 13a is tests/test_online.py:387's acceptance fleet, whose generous
    # hot tier the re-plans must keep; 13b's K/2 caps on tiers 1 and 3
    # are meant to bind under the burst: its infeasible re-solves hand
    # their tenants to admission control, and the report says where
    if not four and not report["ok"]:
        raise AssertionError(f"re-planning [{label}]: constraint "
                             f"violations")
    return eng, chunks, launches, {"rate": rate, "records": records,
                                   "tiers": tiers, "planned": planned}


def rp_cpu_parity(label, eng, models, four, chunks, tiers, planned):
    """The sampled streams through the port's own CPU run of the same
    chunks, the CPU pinned to the card's re-solve (backend "device":
    plan_solve's plain version) and started from the card's planned
    boundaries and cascade flags, given explicitly beside each cost
    model. Detection and re-solve are per stream, so the sub-fleet sees
    the card's decisions."""
    from repro_torch.online import drift
    from repro_torch.streams import StreamEngine, StreamSpec
    sample = chunks.sample
    bounds, mig = planned
    rows = [eng.stream_row(int(i)) for i in sample]
    specs = [StreamSpec(stream_id=int(i), k=RP_K, cost_model=models[i],
                        migrate=bool(mig[r]), boundaries=tuple(bounds[r]))
             for i, r in zip(sample, rows)]
    cpu = StreamEngine(specs, constraints=rp_constraints(four),
                       replan=rp_config(), device="cpu")
    cpu._replanner.backend = "device"  # the card's re-solve, plain plan_solve
    t0 = time.perf_counter()
    cpu.ingest_chunks(chunks.sample_chunks())
    cpu_s = time.perf_counter() - t0
    want = set(int(i) for i in sample)

    def by_stream(evs):
        out = {}
        for e in evs:
            if e.stream_id in want:
                out.setdefault(e.stream_id, []).append(e)
        return out

    got, ref = by_stream(eng.replan_events), by_stream(cpu.replan_events)
    if got.keys() != ref.keys():
        raise AssertionError(f"re-planning [{label}]: the card re-planned "
                             f"other sampled streams than the CPU")
    n_ev, worst = 0, 0.0
    for sid in ref:
        if len(got[sid]) != len(ref[sid]):
            raise AssertionError(f"stream {sid}: {len(got[sid])} events on "
                                 f"the card, {len(ref[sid])} on the CPU")
        for a, b in zip(got[sid], ref[sid]):
            n_ev += 1
            if (a.position, a.rho, a.old_bounds, a.new_bounds, a.applied,
                    a.feasible, a.moved_docs) != (
                    b.position, b.rho, b.old_bounds, b.new_bounds,
                    b.applied, b.feasible, b.moved_docs):
                raise AssertionError(f"stream {sid}: card event {a} != CPU "
                                     f"event {b}")
            for x, y in ((a.suffix_cost_old, b.suffix_cost_old),
                         (a.suffix_cost_new, b.suffix_cost_new),
                         (a.move_bill, b.move_bill)):
                if x == y or (np.isnan(x) and np.isnan(y)):
                    continue
                rel = abs(x - y) / abs(y)
                worst = max(worst, rel)
                if not rel <= 1e-11:
                    raise AssertionError(f"stream {sid}: suffix cost {x} "
                                         f"on the card, {y} on the CPU")
    adm = lambda evs: sorted(  # noqa: E731
        (e.stream_id, e.position, e.decision.admitted, e.decision.negotiated,
         e.decision.k, e.decision.n_docs) for e in evs if e.stream_id in want)
    if adm(eng.admission_events) != adm(cpu.admission_events):
        raise AssertionError(f"re-planning [{label}]: admission events "
                             f"differ")
    ds_g = drift.state_to_numpy(eng._drift_states[0])
    ds_c = drift.state_to_numpy(cpu._drift_states[0])
    for f in ds_g:
        if not np.array_equal(ds_g[f][rows].view(np.uint8),
                              ds_c[f].view(np.uint8)):
            raise AssertionError(f"drift leaf {f} differs on the card")
    if not np.array_equal(eng.meter.boundaries[rows], cpu.meter.boundaries):
        raise AssertionError("boundaries differ from the CPU run")
    ct = cpu.finalize_tiers()
    for i in sample:
        for key in ("ids", "tiers", "counts"):
            if not np.array_equal(tiers[int(i)][key], ct[int(i)][key]):
                raise AssertionError(f"stream {i}: {key} differ from the "
                                     f"CPU run")
    log(f"re-planning [{label}]: {len(sample)} sampled streams through the "
        f"port's CPU run of the same chunks in {cpu_s:.3f}s: {n_ev} replan "
        f"events identical (positions, rho, applied, feasible, old and new "
        f"bounds bit for bit; suffix costs and bills max rel diff "
        f"{worst:.3g} <= 1e-11), admission events, drift leaves, "
        f"boundaries, survivors and tiers equal")
    return cpu


def rp_oracle(eng, models, chunks):
    """tests/test_online.py:387's acceptance on RP_ORACLE sampled two-tier
    streams: realized re-planned cost below the static plan's and within
    10% of the process oracle's (core.simulator replays)."""
    from repro_torch.online import evaluate
    sched = evaluate.schedules_from_events(eng)
    static = replanned = oracle = 0.0
    t0 = time.perf_counter()
    for j, sid in enumerate(chunks.sample[:RP_ORACLE]):
        sid = int(sid)
        trace = chunks.trace(j)
        row = eng.stream_row(sid)
        base = tuple(b for b in eng.meter.boundaries[row] if np.isfinite(b))
        for ev in eng.replan_events:
            if ev.stream_id == sid:
                base = ev.old_bounds
                break
        cm = models[sid]
        static += evaluate.realized(trace, RP_K, cm, base).cost_total
        replanned += evaluate.realized(trace, RP_K, cm, base,
                                       schedule=sched.get(sid)).cost_total
        oracle += evaluate.process_oracle(
            trace, RP_K, cm, base, RP_DRIFT_AT, [(RP_DRIFT_AT, RP_MULT)],
            np.random.default_rng(sid), grid=10, probes=3)[0]
    log(f"re-planning [13a oracle]: {RP_ORACLE} sampled streams, realized "
        f"cost static {static:.6g}, re-planned {replanned:.6g} "
        f"({replanned / static:.4f} of static), process oracle "
        f"{oracle:.6g} (re-planned {replanned / oracle:.4f} of it; "
        f"simulator replays, {time.perf_counter() - t0:.1f}s)")
    if not (replanned < static and replanned <= 1.10 * oracle):
        raise AssertionError("re-planned fleet missed static or the 10% "
                             "oracle band")


def rp_static_rate(models, seed):
    """13a's fleet without replan=, meter on, over the same chunks."""
    from repro_torch.streams import StreamEngine
    eng = StreamEngine(rp_specs(models), constraints=rp_constraints(False))
    chunks = RpChunks(seed, len(models))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.ingest_chunks(chunks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return len(models) * RP_DOCS / (wall - chunks.gen_s)


def rp_chunk_profile(models, seed, records, smi):
    """A re-planning chunk of 13b under torch.profiler: a fresh engine
    takes the chunks before the one whose re-plan flagged the most
    streams (the run is deterministic), then that chunk is profiled: wall,
    device busy, host share, its plan_solve launches; each launch is then
    timed alone (median of WINDOWS windows) beside its plain version and
    its bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.plan_solve import ops as ps
    from repro_torch.streams import StreamEngine
    target = max((r for r in records if r[4] > 0), key=lambda r: r[1])[0]
    eng = StreamEngine(rp_specs(models), constraints=rp_constraints(True),
                       replan=rp_config())
    it = iter(RpChunks(seed, len(models)))
    eng.ingest_chunks(next(it) for _ in range(target))
    chunk = next(it)
    n_before = len(eng.replan_events)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        seen = capture_plan_solve(lambda: eng.ingest_dense(chunk))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = union_ms(dev)
    ps_ms = union_ms([e for e in dev if "plan_solve" in e.name])
    n_ev = len(eng.replan_events) - n_before
    log(f"re-planning profile [13b, chunk {target}]: {n_ev} streams "
        f"re-planned; wall {wall_ms:.3f} ms (profiler on), device busy "
        f"{busy:.3f} ms ({busy / wall_ms:.3f} of wall), host the rest "
        f"{wall_ms - busy:.3f} ms; {len(dev)} device operations; "
        f"plan_solve {ps_ms:.4f} ms in {len(seen)} launches; {smi}")
    if not seen or ps_ms <= 0:
        raise AssertionError("the profiled re-planning chunk shows no "
                             "plan_solve launch")
    out = []
    for args in seen:
        nbytes, flops = ps_work(args)
        kernel, how = ps_kernel(args)
        med, lo, hi, _ = device_ms_windows(lambda: ps.plan_solve(*args), 20,
                                           kernel, WINDOWS)
        plain = cuda_ms(lambda: ps.reference(*args), 3)
        b_ms, o_ms = (nbytes / HBM_BYTES_PER_S * 1e3,
                      flops / PEAK_FLOPS[args[0].dtype] * 1e3)
        log(f"timing plan_solve [13b re-solve: {ps_shape(args)}; {how}]: "
            f"kernel {med:.4f} ms on the device (median of {WINDOWS} "
            f"windows of 20 calls; min {lo:.4f}, max {hi:.4f}); plain "
            f"{plain:.4f} ms; bound {max(b_ms, o_ms):.4f} ms (bytes "
            f"{b_ms:.4f}, operations {o_ms:.4f})")
        out.append(med)
    return out


def replanning(smi):
    """Phase 13: drift-aware re-planning at fleet scale. Returns the
    launches of both engines' counted runs."""
    rng = np.random.default_rng(13)
    two = two_tier_fleet(rng, RP_TWO)
    four = four_tier_fleet(rng, RP_FOUR)
    launches = {}
    eng, chunks, la, a = replanning_run("13a two-tier", two, False, 131, rng)
    rp_cpu_parity("13a two-tier", eng, two, False, chunks, a["tiers"],
                  a["planned"])
    rp_oracle(eng, two, chunks)
    del eng, chunks
    eng, chunks, lb, b = replanning_run("13b four-tier", four, True, 132, rng)
    rp_cpu_parity("13b four-tier", eng, four, True, chunks, b["tiers"],
                  b["planned"])
    del eng, chunks
    for key in la:
        launches[key] = la[key] + lb[key]
    static = rp_static_rate(two, 131)
    log(f"re-planning [13a two-tier]: {a['rate']:.6g} docs/s with "
        f"replan= beside {static:.6g} docs/s without it, the same fleet "
        f"and chunks, meter on ({a['rate'] / static:.4f} of it); 13b: "
        f"{b['rate']:.6g} docs/s with replan=")
    rp_chunk_profile(four, 132, b["records"], smi)
    return launches


# ---------------------------------------------------------------------------
# phase 14: fleet observability on the card
# ---------------------------------------------------------------------------

OB_SAMPLE = 256  # 14a streams held to the port's CPU run
CB_TENANTS = 8_192  # 14b: examples/cost_attribution.py's fleet at scale
CB_PROFILE_AT = 60  # 14b's first chunk fed through ingest() under the
CB_PROFILED = 2  # profiler, and the number of such chunks
CB_MAX_EVENTS = 4_000_000  # the tracer's bound at 14b's fleet


def count_syncs(fn):
    """``fn()``'s result and the number of synchronizing CUDA operations
    it issued (``torch.cuda.set_sync_debug_mode("warn")`` warns once for
    each)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in caught)


def scrape_counters(url):
    """The typed counters of one /metrics scrape: {sample: value}."""
    import urllib.request
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        text = r.read().decode()
    counters = {line.split()[2] for line in text.splitlines()
                if line.startswith("# TYPE") and line.endswith(" counter")}
    out = {}
    for line in text.splitlines():
        if not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            if name.split("{")[0] in counters:
                out[name] = float(value)
    return out


def fixed_engine(bounds, mig, rows, obs, device=None):
    """An engine over ``rows`` of phase 5's planned fleet (explicit
    boundaries and cascade flags, K=8)."""
    from repro_torch.streams import StreamEngine, StreamSpec
    rows = np.asarray(rows)
    return StreamEngine([StreamSpec(stream_id=int(i), k=K, boundaries=tuple(b),
                                    migrate=bool(g))
                         for i, b, g in zip(rows.tolist(),
                                            bounds[rows].tolist(),
                                            mig[rows].tolist())],
                        obs=obs, device=device)


def busy_ms_per_step(eng, chunks):
    """Compute-engine busy ms a step of ``eng.ingest_chunks(chunks)``
    under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.ingest_chunks(chunks, meter=False)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and "Memcpy" not in e.name]
    return union_ms(dev) / len(chunks), len(dev) / len(chunks)


def obs_main_path(bounds, mig, rate5):
    """14a: phase 5's main path with Observability(ObsConfig(costs=True))
    beside the same engine without obs, over the same chunks."""
    from repro_torch.kernels.batched_topk import ops as btk
    from repro_torch.kernels.tier_assign import ops as ta
    from repro_torch.obs import Observability, ObsConfig
    from repro_torch.obs import costs as costs_mod
    from repro_torch.obs import metrics as metrics_mod
    rng = np.random.default_rng(14)
    first, second = window_chunks(rng, 0), window_chunks(rng, 1)
    prof_chunks = window_chunks(rng, 2, 4)
    sample = np.sort(rng.choice(M, OB_SAMPLE, replace=False))
    # the process's first counted call sees one synchronizing operation
    # whatever it drives (on the H100, of six counted calls on a small
    # fleet the first, obs off, saw one and every later one, obs on or
    # off, none): a throwaway engine takes it
    spare = fixed_engine(bounds, mig, sample, None)
    _, first_syncs = count_syncs(lambda: spare.ingest_chunks(
        [[(ch[0][0][sample], ch[0][1][sample])] for ch in first[:2]],
        meter=False))
    del spare
    runs = {}
    for label in ("off", "on"):
        obs = Observability(ObsConfig(costs=True)) if label == "on" else None
        eng = fixed_engine(bounds, mig, np.arange(M), obs)
        writes = torch.zeros(M, dtype=torch.int32, device=eng.device)
        if obs is None:  # the write-mask totals, from the obs-off run
            dispatch = eng._dispatch

            def counted(batches, dispatch=dispatch, writes=writes):
                wrotes, evs, states = dispatch(batches)
                writes.add_(wrotes[0].sum(1, dtype=torch.int32))
                return wrotes, evs, states

            eng._dispatch = counted
        # the counted run: counters to 0, drive, read
        btk.launches = ta.launches = 0
        _, syncs = count_syncs(lambda: eng.ingest_chunks(first, meter=False))
        tiers = eng.assign_tiers()
        torch.cuda.synchronize()
        launches = {"batched_topk": btk.launches, "tier_assign": ta.launches}
        if launches["batched_topk"] != len(first) or launches[
                "tier_assign"] < 1:
            raise AssertionError(f"obs [14a {label}] missed a kernel: "
                                 f"{launches}")
        runs[label] = dict(eng=eng, syncs=syncs, launches=launches,
                           tiers=tiers, writes=writes)
    off, on = runs["off"], runs["on"]
    eng = on["eng"]
    log(f"obs [14a]: {M} streams, 16 chunks of {M} x {CHUNK}, meter off; "
        f"launches with obs on {on['launches']}; synchronizing CUDA "
        f"operations over the 16 steps (set_sync_debug_mode('warn')): obs "
        f"off {off['syncs']}, obs on {on['syncs']} (the process's first "
        f"counted call, 2 steps of a spare engine: {first_syncs})")
    if on["syncs"] != off["syncs"]:
        raise AssertionError("obs added device-to-host syncs to the step")
    snap, drains = count_syncs(lambda: metrics_mod.snapshot(
        eng._metrics_state))
    log(f"obs [14a]: metrics.snapshot: {drains} synchronizing operation "
        f"(one copy of the packed counters); counters {snap}")
    if drains != 1:
        raise AssertionError(f"snapshot drained in {drains} syncs, not 1")
    # survivors and tiers bit-equal to the obs-off run
    for a, b in zip(off["eng"].states()[0], eng.states()[0]):
        if not torch.equal(a, b):
            raise AssertionError("obs changed the reservoir state")
    for (ta_off, c_off), (ta_on, c_on) in zip(off["tiers"], on["tiers"]):
        if not (torch.equal(ta_off, ta_on) and torch.equal(c_off, c_on)):
            raise AssertionError("obs changed the survivors' tiers")
    # the counter identities
    st = eng.states()[0]
    live = int((st.ids >= 0).sum())
    cs = eng._cost_states[0]
    ledger_writes = cs.writes.sum(1, dtype=torch.int32)
    checks = {
        "DOCS = M x 256": snap["docs"] == M * DOCS,
        "ADMITS - EVICTIONS = live slots":
            snap["admits"] - snap["evictions"] == live,
        "ledger writes = write-mask totals, per stream":
            bool(torch.equal(ledger_writes, off["writes"])),
        "ledger writes = ADMITS": int(cs.writes.sum()) == snap["admits"],
        "ledger deletes = EVICTIONS":
            int(cs.deletes.sum()) == snap["evictions"],
        "BAR_CANDIDATES = DOCS": snap["bar_candidates"] == snap["docs"],
        "CHUNKS = 16": snap["chunks"] == len(first),
    }
    log(f"obs [14a]: survivors and tiers equal the obs-off run bit for "
        f"bit; {live} live slots; identities "
        + ", ".join(f"{k}: {v}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError("a counter identity failed")
    # the sampled streams through the port's CPU run and a card engine of
    # the same streams: ledger rows and ids against the fleet, counters
    # against each other
    sub_chunks = [[(ch[0][0][sample], ch[0][1][sample])] for ch in first]
    cpu = fixed_engine(bounds, mig, sample,
                       Observability(ObsConfig(costs=True)), device="cpu")
    sub = fixed_engine(bounds, mig, sample,
                       Observability(ObsConfig(costs=True)))
    cpu.ingest_chunks(sub_chunks, meter=False)
    sub.ingest_chunks(sub_chunks, meter=False)
    idx = torch.as_tensor(sample, device=eng.device)
    for name in ("writes", "deletes", "resident_steps"):
        rows = getattr(cs, name)[idx].cpu()
        if not (torch.equal(rows, getattr(cpu._cost_states[0], name))
                and torch.equal(rows, getattr(sub._cost_states[0],
                                              name).cpu())):
            raise AssertionError(f"ledger {name} rows differ from the CPU "
                                 f"run")
    for a, b in zip(st, cpu.states()[0]):
        if not torch.equal(a[idx].cpu(), b):
            raise AssertionError("sampled reservoir rows differ from the "
                                 "CPU run")
    c_cpu, s_cpu = metrics_mod.to_canonical(cpu._metrics_state)
    c_sub, s_sub = metrics_mod.to_canonical(sub._metrics_state)
    if not (np.array_equal(c_cpu, c_sub)
            and s_cpu.view(np.int32) == s_sub.view(np.int32)):
        raise AssertionError("the sampled streams' counters differ on the "
                             "card and the CPU")
    log(f"obs [14a]: {OB_SAMPLE} sampled streams: ledger rows and reservoir "
        f"rows equal the port's CPU run bit for bit; packed counters of "
        f"the same streams on the card and the CPU equal "
        f"({c_cpu.tolist()})")
    del cpu, sub
    # docs/s over the next window, obs on and off
    rates = {}
    for label in ("off", "on"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[label]["eng"].ingest_chunks(second, meter=False)
        torch.cuda.synchronize()
        rates[label] = M * CHUNK * len(second) / (time.perf_counter() - t0)
    for a, b in zip(off["eng"].states()[0], eng.states()[0]):
        if not torch.equal(a, b):
            raise AssertionError("obs changed the reservoir state")
    busy = {label: busy_ms_per_step(runs[label]["eng"], prof_chunks)
            for label in ("off", "on")}
    log(f"obs [14a]: ingest of the second window: {rates['on']:.6g} docs/s "
        f"with obs (costs on), {rates['off']:.6g} without "
        f"({rates['on'] / rates['off']:.4f} of it); phase 5: "
        f"{rate5['median']:.6g} (host clock around ingest_chunks and a "
        f"sync, host-made chunks)")
    log(f"obs [14a]: step device time (torch.profiler, 4 steps, compute "
        f"engine busy): obs off {busy['off'][0]:.4f} ms/step in "
        f"{busy['off'][1]:.0f} operations, obs on {busy['on'][0]:.4f} "
        f"ms/step in {busy['on'][1]:.0f}: the counters and the ledger add "
        f"{busy['on'][0] - busy['off'][0]:.4f} ms a step")
    launches = on["launches"]
    del runs, off, on, eng
    return launches


def cost_fleet(m):
    """examples/cost_attribution.py's ``make_fleet`` at the phase's scale:
    every tenant the example's model (a write-cheap hot tier, a
    write-expensive cold one), the first half drifted."""
    from repro_torch.core import costs
    wl = costs.WorkloadSpec(n_docs=RP_DOCS, k=RP_K, doc_gb=1e-4,
                            window_months=0.5)
    cm = costs.TwoTierCostModel(
        tier_a=costs.TierCosts("hot", put_per_doc=1e-6, get_per_doc=2.7e-4,
                               storage_per_gb_month=0.05),
        tier_b=costs.TierCosts("cold", put_per_doc=8e-5, get_per_doc=1e-6,
                               storage_per_gb_month=0.02),
        workload=wl)
    return [cm] * m, np.arange(m) < m // 2


def cb_obs(annotations=False):
    """The example's ObsConfig (and the tracer's bound at fleet scale)."""
    from repro_torch.obs import Observability, ObsConfig
    return Observability(ObsConfig(
        costs=True, cost_trigger=True, cost_alpha=0.01, budget_factor=1.2,
        profiler_annotations=annotations, max_events=CB_MAX_EVENTS))


def cb_replan():
    """The example's nearly blind detector: re-plans come from the cost
    channel."""
    from repro_torch.online import DriftConfig, ReplanConfig
    return ReplanConfig(drift=DriftConfig(alpha=1e-9))


def stream_events(obs, keep=None):
    """The tracer's point events as (name, attrs without the row), in
    order, for the stream ids in ``keep`` (all when None)."""
    out = []
    for e in obs.tracer.events:
        a = e["attrs"]
        if e["kind"] != "event" or (keep is not None
                                    and a.get("stream_id") not in keep):
            continue
        out.append((e["name"], {k: v for k, v in a.items() if k != "row"}))
    return out


def cost_triggered_run(models, drifted, seed, rng, smi):
    """14b's engine on the card: chunks 0..CB_PROFILE_AT-1 and the rest
    through ingest_chunks (timed), CB_PROFILED chunks between them through
    ingest() under torch.profiler, /metrics scraped before and after
    those."""
    import itertools
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.batched_topk import ops as btk
    from repro_torch.kernels.plan_solve import ops as ps
    from repro_torch.kernels.tier_assign import ops as ta
    from repro_torch.obs import http as obs_http
    from repro_torch.streams import StreamEngine
    m = len(models)
    sample = np.sort(rng.choice(m, RP_SAMPLE, replace=False))
    chunks = RpChunks(seed, m, sample, drifted)
    obs = cb_obs(annotations=True)
    # the counted run: counters to 0, plan, drive, finalize, read
    btk.launches = ta.launches = ps.launches = 0
    eng = StreamEngine(rp_specs(models), constraints=rp_constraints(False),
                       replan=cb_replan(), obs=obs)
    planned = (eng.meter.boundaries.copy(), eng.meter.migrate.copy())
    mon_s, curve = [0.0], []
    for mon in (eng._residuals, eng._cost_monitor):
        def timed(*a, _update=mon.update, _cost=mon is eng._cost_monitor):
            t0 = time.perf_counter()
            out = _update(*a)
            mon_s[0] += time.perf_counter() - t0
            if _cost:
                curve.append(eng._cost_monitor.realized_total[drifted].sum())
            return out
        mon.update = timed
    server = obs_http.serve(obs, port=0)
    try:
        it = iter(chunks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.ingest_chunks(itertools.islice(it, CB_PROFILE_AT))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gen_a = chunks.gen_s
        scrapes = [scrape_counters(server.url)]
        profiled = [next(it) for _ in range(CB_PROFILED)]
        gen_b = chunks.gen_s
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for ch in profiled:
                sc, ids = ch[0]
                eng.ingest(np.repeat(np.arange(m), sc.shape[1]),
                           sc.reshape(-1), ids.reshape(-1))
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        scrapes.append(scrape_counters(server.url))
        t0 = time.perf_counter()
        eng.ingest_chunks(it)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        gen_s = gen_a + chunks.gen_s - gen_b
    finally:
        server.stop()
    eng.finalize()
    tiers = eng.finalize_tiers()
    launches = {"batched_topk": btk.launches, "tier_assign": ta.launches,
                "plan_solve": ps.launches}
    n_chunks = len(curve)
    docs = m * (RP_DOCS - sum(ch[0][0].shape[1] for ch in profiled))
    rate = docs / (wall - gen_s)
    log(f"obs [14b]: {m} tenants ({int(drifted.sum())} drifted), K={RP_K}, "
        f"{RP_DOCS} docs each in {n_chunks} chunks of {RP_CHUNK}, meter on, "
        f"cost trigger; launches {launches}; ingest {rate:.6g} docs/s "
        f"({wall:.3f}s for {docs} docs, {gen_s:.3f}s of it making chunks, "
        f"left out; the {CB_PROFILED} profiled chunks left out); the "
        f"residual and cost monitors' host time {mon_s[0]:.3f}s, "
        f"{mon_s[0] / n_chunks * 1e3:.3f} ms a chunk")
    if min(launches.values()) < 1:
        raise AssertionError(f"obs [14b] missed a kernel: {launches}")
    # the profiled window: the tracer's ranges beside the device's work
    names = [e.name for e in prof.events()]
    n_ingest, n_replan = names.count("ingest"), names.count("replan")
    log(f"obs [14b]: torch.profiler window of {CB_PROFILED} chunks through "
        f"ingest() (chunks {CB_PROFILE_AT}-{CB_PROFILE_AT + CB_PROFILED - 1},"
        f" profiler_annotations on): wall {prof_ms:.3f} ms; "
        f"record_function ranges 'ingest' x{n_ingest}, 'replan' x{n_replan}"
        f"; {smi}")
    if n_ingest < CB_PROFILED or n_replan < 1:
        raise AssertionError("the profiler window lacks the ingest or "
                             "replan ranges")
    # the live endpoint
    # drift_fired is the number of detectors latched now: the reference
    # types it a counter, but a re-plan's reset lowers it, so it is logged
    # and not held to never decrease
    first, second = scrapes
    fired = [(first[k], second.get(k)) for k in first
             if k.endswith("_drift_fired")]
    grew = [k for k in first if second.get(k, -1.0) > first[k]]
    fell = [k for k in first if second.get(k, -1.0) < first[k]
            and not k.endswith("_drift_fired")]
    log(f"obs [14b]: /metrics on 127.0.0.1 scraped after chunk "
        f"{CB_PROFILE_AT - 1} and after chunk "
        f"{CB_PROFILE_AT + CB_PROFILED - 1}: {len(first)} typed counters, "
        f"{len(grew)} grew, {len(fell)} fell (drift_fired, latched "
        f"detectors: {fired})")
    if fell or not first or not any(k.endswith("engine_docs") for k in grew):
        raise AssertionError(f"/metrics counters fell or did not grow: "
                             f"{fell[:4]}")
    return eng, obs, chunks, launches, dict(
        rate=rate, curve=np.asarray(curve), tiers=tiers, planned=planned,
        mon_ms=mon_s[0] / n_chunks * 1e3)


def cost_chain(eng, obs, drifted, curve):
    """examples/cost_attribution.py's chain on the fleet: a burn or cost
    alert on drifted tenants, cost-triggered re-plans, and the drifted
    tenants' realized-cost slope lower after them."""
    from collections import Counter
    evs = list(obs.tracer.events)
    kinds = Counter(e["name"] for e in evs)
    log(f"obs [14b]: events per kind {dict(sorted(kinds.items()))}; "
        f"dropped {obs.tracer.dropped}")
    if obs.tracer.dropped:
        raise AssertionError("the tracer dropped events")
    fired = [e["attrs"] for e in evs
             if e["name"] in ("cost_alert", "budget_burn")]
    on_drifted = sum(bool(drifted[a["row"]]) for a in fired)
    applied = [e["attrs"] for e in evs if e["name"] == "replan_decision"
               and e["attrs"]["cost_triggered"] and e["attrs"]["applied"]]
    first_at = {}
    for a in applied:
        if drifted[a["row"]]:
            first_at.setdefault(a["row"], a["position"])
    if not on_drifted or not first_at:
        raise AssertionError("no cost/burn alert on a drifted tenant, or no "
                             "cost-triggered re-plan applied to one")
    # the drifted tenants' curve bends at the median first re-plan
    rc = min(int(np.median(list(first_at.values()))) // RP_CHUNK,
             len(curve) - 3)
    dc = RP_DRIFT_AT // RP_CHUNK
    pre = (curve[rc] - curve[dc]) / max(rc - dc, 1)
    post = (curve[-1] - curve[rc + 1]) / max(len(curve) - rc - 2, 1)
    log(f"obs [14b]: {len(fired)} cost/burn alerts ({on_drifted} on drifted "
        f"tenants); {len(applied)} cost-triggered re-plans applied, "
        f"{len(first_at)} of {int(drifted.sum())} drifted tenants re-planned "
        f"(median first at doc {rc * RP_CHUNK}); the drifted tenants' "
        f"realized-cost slope per chunk {pre:.6g} from the burst to it, "
        f"{post:.6g} after it ({post / pre:.4f})")
    if not post < pre:
        raise AssertionError("the cost-triggered re-plans did not bend the "
                             "drifted tenants' cost curve")


def replan_key(e):
    """A re-plan event's fields but its row (a fleet's row and a sampled
    sub-fleet's differ)."""
    return (e.stream_id, e.position, e.rho, e.old_bounds, e.new_bounds,
            e.applied, e.feasible, e.suffix_cost_old, e.suffix_cost_new,
            e.move_bill, e.moved_docs)


def cost_cpu_parity(eng, obs, models, chunks, planned):
    """The sampled tenants through the port's CPU run and a card engine of
    the same tenants (both from the card's planned boundaries, the CPU
    pinned to the device re-solve): per stream against the fleet,
    alerts, burn events, re-plan events, ledger rows and cost_summary;
    the sub-fleets' snapshots and events against each other, the drift
    score within 1 ulp."""
    import json as json_mod
    from repro_torch.obs import costs as costs_mod
    from repro_torch.streams import StreamEngine, StreamSpec
    sample = chunks.sample
    bounds, mig = planned
    rows = np.array([eng.stream_row(int(i)) for i in sample])
    specs = [StreamSpec(stream_id=int(i), k=RP_K, cost_model=models[i],
                        migrate=bool(mig[r]), boundaries=tuple(bounds[r]))
             for i, r in zip(sample, rows)]
    subs, obses = [], []
    for device in ("cpu", None):
        o = cb_obs()
        e = StreamEngine(specs, constraints=rp_constraints(False),
                         replan=cb_replan(), obs=o, device=device)
        e._replanner.backend = "device"
        t0 = time.perf_counter()
        e.ingest_chunks(chunks.sample_chunks())
        e.finalize()
        subs.append((e, time.perf_counter() - t0))
        obses.append(o)
    (cpu, cpu_s), (card, _) = subs
    keep = {int(i) for i in sample}
    want = stream_events(obses[0])
    if stream_events(obs, keep) != want or stream_events(obses[1]) != want:
        raise AssertionError("the sampled tenants' events differ from the "
                             "CPU run")
    alerts = eng.cost_alerts()
    if {s: a for s, a in alerts.items() if s in keep} != cpu.cost_alerts():
        raise AssertionError("cost alerts differ from the CPU run")
    res = eng.residual_alerts()
    if {s: a for s, a in res.items() if s in keep} != cpu.residual_alerts():
        raise AssertionError("residual alerts differ from the CPU run")
    if [replan_key(e) for e in eng.replan_events if e.stream_id in keep] \
            != [replan_key(e) for e in cpu.replan_events]:
        raise AssertionError("re-plan events differ from the CPU run")
    full, part = eng.cost_summary(), cpu.cost_summary()
    for key in ("writes", "reads", "storage", "migration", "total",
                "planned", "regret"):
        if not np.array_equal(full[key][rows], part[key]):
            raise AssertionError(f"cost_summary {key} differs")
    for key in full["device"]:
        if not np.array_equal(full["device"][key][rows],
                              part["device"][key]):
            raise AssertionError(f"ledger {key} rows differ")
    a, b = cpu.obs_snapshot(), card.obs_snapshot()
    sa, sb = a["engine"].pop("drift_score_max"), \
        b["engine"].pop("drift_score_max")
    ulps = abs(int(np.float32(sa).view(np.int32))
               - int(np.float32(sb).view(np.int32)))
    if json_mod.dumps(a, sort_keys=True) != json_mod.dumps(b, sort_keys=True) \
            or ulps > 1:
        raise AssertionError("the sampled sub-fleet's snapshot differs on "
                             "the card and the CPU")
    if costs_mod.snapshot(cpu) != costs_mod.snapshot(card):
        raise AssertionError("cost snapshots differ")
    n_ev = len(want)
    log(f"obs [14b]: {len(sample)} sampled tenants through the port's CPU "
        f"run of the same chunks ({cpu_s:.3f}s) and a card engine of the "
        f"same tenants: {n_ev} events (residual and cost alerts, budget "
        f"burns, re-plan decisions, admissions) equal the fleet's in order, "
        f"cost and residual alerts, re-plan events, ledger rows and "
        f"cost_summary bit for bit; snapshots equal, drift_score_max "
        f"{sa!r} on the CPU, {sb!r} on the card ({ulps} ulp)")


def cost_triggered(smi):
    """14b: examples/cost_attribution.py's setting at CB_TENANTS."""
    from collections import Counter
    rng = np.random.default_rng(141)
    models, drifted = cost_fleet(CB_TENANTS)
    eng, obs, chunks, launches, r = cost_triggered_run(models, drifted, 142,
                                                       rng, smi)
    cost_chain(eng, obs, drifted, r["curve"])
    counts = np.stack([r["tiers"][i]["counts"] for i in range(CB_TENANTS)])
    if int(counts.sum()) != CB_TENANTS * RP_K:
        raise AssertionError("finalize_tiers counts do not sum to M*K")
    out_dir = ROOT / "build" / "obs14b"
    paths = obs.write(str(out_dir))
    sizes = {k: Path(v).stat().st_size for k, v in paths.items()}
    log(f"obs [14b]: Observability.write: {sizes} bytes under "
        f"{out_dir.relative_to(ROOT)}")
    if sorted(sizes) != ["events", "metrics", "prometheus"] or \
            min(sizes.values()) == 0:
        raise AssertionError("Observability.write missed an artifact")
    cost_cpu_parity(eng, obs, models, chunks, r["planned"])
    snap = eng.obs_snapshot()
    log(f"obs [14b]: fleet snapshot: engine {snap['engine']}; costs "
        f"realized {snap['costs']['realized']['total']:.6g}, planned "
        f"{snap['costs']['planned_total']:.6g}, alerts "
        f"{snap['costs']['alerts']}")
    del eng, obs, chunks
    # the same fleet and chunks without obs=
    from repro_torch.streams import StreamEngine
    plain = StreamEngine(rp_specs(models), constraints=rp_constraints(False),
                         replan=cb_replan())
    chunks = RpChunks(142, CB_TENANTS, None, drifted)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain.ingest_chunks(chunks)
    torch.cuda.synchronize()
    rate = CB_TENANTS * RP_DOCS / (time.perf_counter() - t0 - chunks.gen_s)
    log(f"obs [14b]: {r['rate']:.6g} docs/s with obs (costs, cost trigger) "
        f"beside {rate:.6g} docs/s without obs= ({r['rate'] / rate:.4f} of "
        f"it; the same fleet and chunks, replan= and meter on both); "
        f"{len(plain.replan_events)} replan events without obs "
        f"({dict(Counter(e.applied for e in plain.replan_events))} applied)")
    return launches


def observability(bounds, mig, rate5, smi):
    """Phase 14. Returns the launches of both counted runs."""
    launches = obs_main_path(bounds, mig, rate5)
    for key, n in cost_triggered(smi).items():
        launches[key] = launches.get(key, 0) + n
    return launches


# ---------------------------------------------------------------------------
# the launcher batch: the launcher subprocesses of 15c, 16c, 17d and 22c
# ---------------------------------------------------------------------------

READY_S = 300.0  # a launcher's first checkpoint, as when each ran alone


@dataclasses.dataclass
class Launch:
    """A launcher subprocess of the batch: its argv and time limit, and
    ``ready``, a test whose first success (within READY_S seconds) sends
    it SIGTERM; None lets it run to its end. The batch fills in its
    stdout, stderr, exit code, wall seconds and the seconds until
    ``ready``."""
    argv: list
    limit: float
    ready: object = None
    out: str = ""
    err: str = ""
    rc: int | None = None
    wall: float = 0.0
    first_s: float | None = None


def launcher_runs():
    """The batch's six launchers: 15c's serve drained by SIGTERM after its
    first checkpoint, 16c's serve with --mesh 2 and without, 17d's
    training drained after its first checkpoint, and 22c's training of
    the reduced grok-1-314b and deepseek-v2-236b; their limits as when
    each ran alone."""
    serve = [sys.executable, "-m", "repro_torch.launch.serve"]
    train = [sys.executable, "-m", "repro_torch.launch.train"]
    ckpt = DRAIN_DIR / "ckpt"
    first = TRAIN_DIR / "ckpt_00000020" / "manifest.json"
    runs = {
        "15c": Launch([*serve, *DRAIN_ARGV, "--ckpt-dir", str(ckpt),
                       "--obs-out", str(DRAIN_DIR / "obs")], 420.0,
                      ready=lambda: ckpt.is_dir() and any(
                          d.startswith("ckpt_") for d in os.listdir(ckpt))),
        "16c mesh": Launch([*serve, *MESH_ARGV, "--mesh", "2"], 300.0),
        "16c plain": Launch([*serve, *MESH_ARGV], 300.0),
        "17d": Launch([*train, *TRAIN_ARGV, "--ckpt-dir", str(TRAIN_DIR)],
                      600.0, ready=first.exists)}
    for arch in (GK_ARCH, DS_ARCH):
        runs[f"22c {arch}"] = Launch([*train, "--arch", arch, *TC_ARGV],
                                     600.0)
    return runs


class LauncherBatch:
    """The six launchers of ``launcher_runs`` started at once on the card
    (each its own interpreter and CUDA context) and watched by one
    polling loop on a thread, while this process goes on with work that
    is not timed: SIGTERM to a child once its ``ready`` holds, its exit
    code and wall when it ends. A child that misses its checkpoint or its
    limit ends the batch, every child killed; ``wait`` then raises."""

    def __init__(self):
        self.runs = launcher_runs()
        self.logs = ROOT / "build" / "launchers"
        self.procs, self.error = {}, None

    def start(self):
        import shutil
        for d in (DRAIN_DIR, TRAIN_DIR, self.logs):
            shutil.rmtree(d, ignore_errors=True)
        self.logs.mkdir(parents=True)
        torch.cuda.empty_cache()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        self.t0 = time.perf_counter()
        for name, run in self.runs.items():
            with open(self.stem(name) + ".out", "w") as out, \
                    open(self.stem(name) + ".err", "w") as err:
                self.procs[name] = subprocess.Popen(
                    run.argv, stdout=out, stderr=err, cwd=ROOT, env=env)
        self.watcher = threading.Thread(target=self.watch, daemon=True)
        self.watcher.start()

    def stem(self, name):
        return str(self.logs / name.replace(" ", "_"))

    def watch(self):
        import signal
        try:
            while any(run.rc is None for run in self.runs.values()):
                now = time.perf_counter() - self.t0
                for name, proc in self.procs.items():
                    run = self.runs[name]
                    if run.rc is not None:
                        continue
                    rc = proc.poll()
                    if run.ready and run.first_s is None:
                        if run.ready():
                            run.first_s = now
                            proc.send_signal(signal.SIGTERM)
                        elif rc is not None or now > READY_S:
                            raise AssertionError(f"launcher {name}: no "
                                                 f"first checkpoint (exit "
                                                 f"{rc})")
                    if rc is not None:
                        run.rc, run.wall = rc, now
                    elif now > run.limit:
                        raise AssertionError(f"launcher {name}: still "
                                             f"running after "
                                             f"{run.limit:.0f}s")
                # 17d's first checkpoint comes 20 steps before its last
                time.sleep(0.005)
        except AssertionError as e:
            self.error = str(e)
        finally:
            self.wall = time.perf_counter() - self.t0
            self.kill()

    def kill(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def wait(self):
        """Waits for every child; logs each one's wall and the batch's
        beside their sum. Returns the runs by name, for the checks of
        15c, 16c, 17d and 22c, and the sum less the batch's wall."""
        import shutil
        self.watcher.join()
        if self.error:
            raise AssertionError(self.error)
        for name, run in self.runs.items():
            run.out = Path(self.stem(name) + ".out").read_text()
            run.err = Path(self.stem(name) + ".err").read_text()
            sent = (f", SIGTERM after {run.first_s:.3f}s" if run.first_s
                    is not None else "")
            log(f"launcher batch [{name}] {' '.join(run.argv[1:])}: exit "
                f"{run.rc} after {run.wall:.3f}s{sent}")
        total = sum(run.wall for run in self.runs.values())
        log(f"launcher batch: {len(self.runs)} launchers at once in "
            f"{self.wall:.3f}s of wall; the sum of their own walls "
            f"{total:.3f}s, {total - self.wall:.3f}s more; "
            f"{os.cpu_count()} CPUs (os.cpu_count())")
        shutil.rmtree(self.logs, ignore_errors=True)
        return self.runs, total - self.wall


# ---------------------------------------------------------------------------
# phase 15: crash recovery, the chaos drill and graceful drain on the card
# ---------------------------------------------------------------------------

RS_CHUNKS, RS_EVERY, RS_LOSS_AT = 16, 4, 9  # 15a: chunks, cadence, loss
# seed 14 draws every fault kind in 16 chunks: 4 failed deliveries, 4
# duplicates, reorderings, and NaN lacing of chunks 8 and 11 (one on each
# side of the loss)
RS_FAULTS = dict(seed=14, transient_rate=0.1, duplicate_rate=0.1,
                 reorder_rate=0.1, nan_rate=0.05)
CH_TENANTS, CH_K, CH_W = 4_096, 8, 32  # 15b: examples/chaos_recovery.py
CH_CHUNKS, CH_EXTRA, CH_EVERY, CH_KILL_AT = 12, 6, 2, 7
CH_SAMPLE = 512  # 15b tenants held to the port's CPU run
DRAIN_DIR = ROOT / "build" / "drain15c"  # 15c's checkpoints and obs
DRAIN_ARGV = ["--device", "cuda", "--tenants", "8", "--requests", "64",
              "--batch", "8", "--ckpt-every", "1", "--obs-hold", "60"]


def timed_checkpointer(directory, every):
    """A ``FleetCheckpointer`` that keeps the seconds of each save's
    caller-side part (the snapshot's device→host copies and the hand-off
    to the writer thread) and of each restore."""
    from repro_torch.resilience import FleetCheckpointer

    class Timed(FleetCheckpointer):
        def save(self, engine, blocking=False):
            t0 = time.perf_counter()
            gen = super().save(engine, blocking=blocking)
            self.save_s.append(time.perf_counter() - t0)
            return gen

        def restore(self, engine, step=None, verify=True):
            t0 = time.perf_counter()
            gen = super().restore(engine, step=step, verify=verify)
            self.restore_s.append(time.perf_counter() - t0)
            return gen

    ck = Timed(directory, every=every)
    ck.save_s, ck.restore_s = [], []
    return ck


def ckpt_bytes(ck):
    """Bytes of the latest committed checkpoint's files."""
    _, path = ck.manager._lookup(None)
    return sum(f.stat().st_size for f in Path(path).iterdir())


def recovery_state(eng):
    """What 15a holds bit for bit: every bucket's state leaves, the
    tiers and per-tier counts assign_tiers gives, every meter ledger."""
    out = {f"state{bi}.{i}": t.cpu().numpy()
           for bi, st in enumerate(eng.states()) for i, t in enumerate(st)}
    for bi, pair in enumerate(eng.assign_tiers()):
        if pair is not None:
            out[f"tiers{bi}"], out[f"counts{bi}"] = (pair[0].cpu().numpy(),
                                                     pair[1].cpu().numpy())
    out.update({f"meter.{k}": v for k, v in eng.meter.state_dict().items()})
    return out


def crash_recovery(bounds, mig):
    """15a: the mixed fleet of phase 8 under the fault harness, meter on:
    an uninterrupted run beside run_with_recovery with a device loss;
    then docs/s of ingest_chunks with and without a checkpointer."""
    import shutil
    from repro_torch.checkpoint import CheckpointCorruptError
    from repro_torch.kernels.batched_topk import ops as btk
    from repro_torch.kernels.logmem_update import ops as lm_ops
    from repro_torch.kernels.tier_assign import ops as ta
    from repro_torch.resilience import (FaultyChunkSource, FleetCheckpointer,
                                        ingest_with_faults, run_with_recovery)
    from repro_torch.streams import StreamEngine, StreamSpec
    specs = [StreamSpec(stream_id=i, k=K, boundaries=tuple(b),
                        migrate=bool(g))
             for i, (b, g) in enumerate(zip(bounds.tolist(), mig.tolist()))]
    specs += [StreamSpec(stream_id=M + j, k=LM_K, r=float(4 * LM_K),
                         engine="logmem") for j in range(LM_STREAMS)]
    chunks = mixed_window_chunks(np.random.default_rng(15), 0, RS_CHUNKS)
    make_chunk = chunks.__getitem__  # a pure function of the index
    t0 = time.perf_counter()
    ref = StreamEngine(specs)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_src = FaultyChunkSource(make_chunk, RS_CHUNKS, **RS_FAULTS)
    ref_stats = ingest_with_faults(ref, ref_src, sleep_scale=0.0)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    want = recovery_state(ref)
    directory = ROOT / "build" / "ckpt15a"
    shutil.rmtree(directory, ignore_errors=True)
    ck = timed_checkpointer(str(directory), RS_EVERY)
    src = FaultyChunkSource(make_chunk, RS_CHUNKS, device_loss_at=RS_LOSS_AT,
                            **RS_FAULTS)
    # the counted run: counters to 0, drive, read
    btk.launches = ta.launches = lm_ops.launches = 0
    t0 = time.perf_counter()
    eng, stats = run_with_recovery(lambda: StreamEngine(specs), src, ck,
                                   sleep_scale=0.0)
    ck.wait()
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    got = recovery_state(eng)
    launches = {"batched_topk": btk.launches, "tier_assign": ta.launches,
                "logmem_update": lm_ops.launches}
    log(f"resilience [15a]: launches {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"15a missed a kernel: {launches}")
    bad = [k for k in want if not np.array_equal(want[k], got[k])]
    log(f"resilience [15a]: {M} exact streams + {LM_STREAMS} logmem tenants "
        f"at K={LM_K}, {RS_CHUNKS} chunks, meter on: uninterrupted run "
        f"{ref_s:.3f}s ({ref_stats}; the source injected "
        f"{ref_src.failures_injected} failures, "
        f"{ref_src.duplicates_injected} duplicates, {ref_src.nan_injected} "
        f"NaN/Inf scores; engine built in {build_s:.3f}s); "
        f"run_with_recovery with a device loss at chunk {RS_LOSS_AT} "
        f"{rec_s:.3f}s (two engine builds, saves and the restore "
        f"included): {stats}; {len(want) - len(bad)}/{len(want)} leaves "
        f"(states, assign_tiers, meter) equal bit for bit")
    if bad or stats["restarts"] != 1 or eng.chunks_ingested != RS_CHUNKS:
        raise AssertionError(f"15a recovery differs: {bad[:8]}, {stats}")
    nbytes = ckpt_bytes(ck)
    reservoir = sum(t.numel() * t.element_size() for t in eng.states()[0])
    log(f"resilience [15a]: checkpoint {nbytes} bytes ({reservoir} of them "
        f"the exact reservoirs), generation {ck.manager.generation()}; "
        f"saves' host copies and hand-off "
        f"{[round(s * 1e3, 3) for s in ck.save_s]} ms; the last write + "
        f"sha256 on the worker {ck.manager.last_write_s * 1e3:.3f} ms; "
        f"restore {[round(s * 1e3, 3) for s in ck.restore_s]} ms")
    # a torn save is ignored; a corrupted leaf is refused
    latest = ck.manager.latest_step()
    torn = directory / "ckpt_00000099.tmp"
    torn.mkdir()
    (torn / "leaf_00000.npy").write_bytes(b"torn")
    if ck.manager.latest_step() != latest:
        raise AssertionError("a torn .tmp save was listed")
    _, path = ck.manager._lookup(None)
    leaf = Path(path) / "leaf_00000.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    try:
        ck.restore(ref)
    except CheckpointCorruptError as e:
        log(f"resilience [15a]: torn .tmp save ignored (latest step "
            f"{latest}); a flipped byte refused: {str(e)[-60:]}")
    else:
        raise AssertionError("a corrupted leaf restored")
    # docs/s with and without a checkpointer: the next two windows of
    # the same chunks' scores (ids continued), meter off, in turns
    del chunks
    rng = np.random.default_rng(151)
    windows = [mixed_window_chunks(rng, w, RS_CHUNKS) for w in (1, 2)]
    ref.attach_checkpointer(FleetCheckpointer(str(directory / "b"),
                                              every=RS_EVERY))
    rates = {"off": [], "on": []}
    docs = (M * CHUNK + LM_STREAMS * LM_CHUNK) * RS_CHUNKS
    for name, e, w in (("off", eng, 0), ("on", ref, 0), ("on", ref, 1),
                       ("off", eng, 1)):
        if name == "off":
            e._checkpoint = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.ingest_chunks(windows[w], meter=False)
        if e._checkpoint is not None:
            e._checkpoint.wait()
        torch.cuda.synchronize()
        rates[name].append(docs / (time.perf_counter() - t0))
    on, off = statistics.mean(rates["on"]), statistics.mean(rates["off"])
    log(f"resilience [15a]: ingest_chunks, meter off, {RS_CHUNKS} chunks a "
        f"window: {rates['off'][0]:.6g} and {rates['off'][1]:.6g} docs/s "
        f"without a checkpointer, {rates['on'][0]:.6g} and "
        f"{rates['on'][1]:.6g} with every={RS_EVERY} ({on / off:.4f} of "
        f"it; host clock around ingest_chunks, the last write and a sync)")
    shutil.rmtree(directory, ignore_errors=True)
    return launches


def chaos_engine(device=None, obs=None, tenants=None, rows=None,
                 planned=None):
    """examples/chaos_recovery.py's fleet at ``CH_TENANTS``: three-tier
    tenants, half planned and half pinned to (32, 0.8 N), re-planning and
    cost attribution on. With ``rows`` the engine holds those tenants
    alone, at ``planned`` (the full fleet's boundaries and cascade
    flags by stream id) for the planned ones."""
    from repro_torch.core import topology
    from repro_torch.obs import Observability, ObsConfig
    from repro_torch.online import DriftConfig, ReplanConfig
    from repro_torch.streams import StreamEngine, StreamSpec
    n = (CH_CHUNKS + CH_EXTRA) * CH_W
    specs = []
    for t in (range(CH_TENANTS) if rows is None else rows):
        t = int(t)
        cm = topology.hbm_dram_disk_preset(
            n_docs=n, k=CH_K, doc_gb=1e-4, window_seconds=30.0 * (1 + t % 3))
        if t % 2:
            kw = dict(boundaries=(32.0, n * 0.8))
        elif planned is not None:
            kw = dict(boundaries=planned[t][0], migrate=planned[t][1])
        else:
            kw = {}
        specs.append(StreamSpec(stream_id=t, k=CH_K, cost_model=cm, **kw))
    obs = obs if obs is not None else Observability(ObsConfig(
        costs=True, max_events=CB_MAX_EVENTS))
    return StreamEngine(specs, obs=obs, device=device,
                        replan=ReplanConfig(drift=DriftConfig(alpha=0.05)))


def chaos_chunk(i, rows=None):
    """Chunk ``i`` as a pure function of its index (the example's
    ``make_chunk``: the first half of the rows heats up from chunk 4);
    with ``rows``, those rows of it."""
    r = np.random.default_rng(150 + i)
    s = r.random((CH_TENANTS, CH_W)).astype(np.float32)
    if i >= 4:
        s[: CH_TENANTS // 2] += 0.5
    ids = np.tile(np.arange(i * CH_W, (i + 1) * CH_W, dtype=np.int32),
                  (CH_TENANTS, 1))
    if rows is not None:
        s, ids = s[rows], ids[rows]
    return [(s, ids)]


def chaos_digest(eng) -> str:
    """sha256 over the survivors and every host ledger (meter and cost
    monitor), the example's ``digest`` without its final read."""
    import hashlib
    h = hashlib.sha256()
    surv = eng.survivors()
    for sid in sorted(surv):
        h.update(np.ascontiguousarray(surv[sid]))
    for _, arr in sorted(eng.meter.state_dict().items()):
        h.update(np.ascontiguousarray(arr))
    for _, arr in sorted(eng._cost_monitor.state_dict().items()):
        h.update(np.ascontiguousarray(np.asarray(arr)))
    return h.hexdigest()


def chaos_child(directory):
    """The drill's child process: ingest with checkpoints every
    ``CH_EVERY`` chunks (async), then SIGKILL itself after chunk
    ``CH_KILL_AT`` — no flush, a save possibly in flight."""
    import os
    import signal
    from repro_torch.resilience import FleetCheckpointer
    eng = chaos_engine()
    eng.attach_checkpointer(FleetCheckpointer(directory, every=CH_EVERY))
    for i in range(CH_CHUNKS):
        eng.ingest_dense(chaos_chunk(i))
        if i == CH_KILL_AT:
            os.kill(os.getpid(), signal.SIGKILL)
    return 3  # the child was supposed to die


def evac_bills(eng, rr0, rw0):
    """Per-row relocation bills since the (reloc_reads, reloc_writes)
    snapshot, priced as ``_evacuate_tier`` prices them."""
    d_rr = (eng.meter.reloc_reads - rr0).astype(np.float64)
    d_rw = (eng.meter.reloc_writes - rw0).astype(np.float64)
    return (d_rr * eng._pricing["cr"]).sum(1) \
        + (d_rw * eng._pricing["cw"]).sum(1)


def outage_drill(eng, rows=None):
    """The drill's second half on ``eng``: tier 1 fails after chunk
    ``CH_CHUNKS``, half the extra chunks ingest through the outage, the
    tier recovers (hysteresis 2), the rest ingest. Returns the
    evacuation summary, per-row bills, the evacuation's host seconds and
    the tier-1 occupancy at the end of the outage."""
    from repro_torch.resilience import TierOutage
    mid = CH_CHUNKS + CH_EXTRA // 2
    rr0, rw0 = eng.meter.reloc_reads.copy(), eng.meter.reloc_writes.copy()
    t0 = time.perf_counter()
    with TierOutage(eng, tier=1, burn_grace=8, hysteresis=2) as drill:
        evac_s = time.perf_counter() - t0
        bills = evac_bills(eng, rr0, rw0)
        for i in range(CH_CHUNKS, mid):
            eng.ingest_dense(chaos_chunk(i, rows))
        occupied = int(eng.meter.occupancy[:, 1].sum())
    for i in range(mid, CH_CHUNKS + CH_EXTRA):
        eng.ingest_dense(chaos_chunk(i, rows))
    return drill.summary, bills, evac_s, occupied


def chaos_drill():
    """15b: examples/chaos_recovery.py at ``CH_TENANTS`` tenants on the
    card — kill -9 of a child mid-window, restore and replay bit for bit;
    then a tier-1 outage under load, and 512 sampled tenants against the
    port's CPU run of the same chunks and the same outage."""
    import shutil
    import subprocess
    from collections import Counter
    from repro_torch.kernels.batched_topk import ops as btk
    from repro_torch.kernels.plan_solve import ops as ps
    from repro_torch.kernels.tier_assign import ops as ta
    from repro_torch.online import evaluate
    from repro_torch.resilience import FleetCheckpointer
    ref = chaos_engine()
    for i in range(CH_CHUNKS):
        ref.ingest_dense(chaos_chunk(i))
    want = chaos_digest(ref)
    del ref
    directory = ROOT / "build" / "ckpt15b"
    shutil.rmtree(directory, ignore_errors=True)
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--chaos-child",
         str(directory)], capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if child.returncode != -9:
        raise AssertionError(f"the child did not die by SIGKILL (rc "
                             f"{child.returncode}):\n{child.stdout[-2000:]}"
                             f"\n{child.stderr[-2000:]}")
    # the counted run: counters to 0, drive (plan, restore, replay, the
    # outage, finalize_tiers), read
    btk.launches = ta.launches = ps.launches = 0
    eng = chaos_engine()
    b, g = eng.meter.boundaries, eng.meter.migrate
    planned = {sid: (tuple(b[row].tolist()), bool(g[row]))
               for sid, row in eng._row_of.items()}
    ck = FleetCheckpointer(str(directory), every=CH_EVERY)
    t0 = time.perf_counter()
    gen = ck.restore(eng)
    restore_s = time.perf_counter() - t0
    cursor = eng.chunks_ingested
    eng.attach_checkpointer(ck)
    for i in range(cursor, CH_CHUNKS):
        eng.ingest_dense(chaos_chunk(i))
    got = chaos_digest(eng)
    log(f"resilience [15b]: {CH_TENANTS} tenants, K={CH_K}, W={CH_W}: the "
        f"child SIGKILLed itself after chunk {CH_KILL_AT} (rc "
        f"{child.returncode}, {child_s:.3f}s with its start-up); restored "
        f"generation {gen} at chunk {cursor} in {restore_s * 1e3:.3f} ms, "
        f"replayed {CH_CHUNKS - cursor} chunks; digest {got[:16]} vs the "
        f"uninterrupted run's {want[:16]}")
    if got != want or not CH_KILL_AT - CH_EVERY < cursor <= CH_KILL_AT + 1:
        raise AssertionError("the drill's recovery is not bit for bit")
    summary, bills, evac_s, occupied = outage_drill(eng)
    mon = eng._cost_monitor
    evac = np.zeros(eng.m, bool)
    evac[summary["rows"]] = True
    false_fires = int(mon.burn_alerted[evac].sum())
    tiers = eng.finalize_tiers()
    launches = {"batched_topk": btk.launches, "tier_assign": ta.launches,
                "plan_solve": ps.launches}
    kinds = Counter(e["name"] for e in eng._obs.tracer.events)
    n_ev = summary["rows_evacuated"]
    log(f"resilience [15b]: tier 1 outage at chunk {CH_CHUNKS}: "
        f"{n_ev} rows evacuated, {len(summary['skipped_rows'])} skipped, "
        f"{len(summary['infeasible_rows'])} infeasible, "
        f"{summary['moved_docs']} docs moved, bill {summary['bill']!r}; "
        f"evacuation {evac_s:.3f}s of host time "
        f"({evac_s * 1e3 / max(n_ev, 1):.3f} ms a row); tier-1 occupancy at "
        f"the end of the outage {occupied}; budget-burn false fires "
        f"{false_fires}; events tier_outage {kinds['tier_outage']}, "
        f"tier_evacuation {kinds['tier_evacuation']}, tier_recovered "
        f"{kinds['tier_recovered']}, checkpoint {kinds['checkpoint']}; "
        f"dropped {eng._obs.tracer.dropped}; launches {launches}")
    if (not n_ev or occupied or false_fires or kinds["tier_outage"] != 1
            or kinds["tier_recovered"] != 1
            or kinds["tier_evacuation"] != n_ev or eng._obs.tracer.dropped
            or launches["batched_topk"] < 1 or launches["tier_assign"] < 1):
        raise AssertionError("the tier outage drill failed")
    counts = sum(int(t["counts"].sum()) for t in tiers.values())
    eng.finalize()
    table = evaluate.regret_table(eng)
    regret = [r["regret"] for r in table]
    log(f"resilience [15b]: regret_table over {len(table)} tenants: "
        f"realized {sum(r['realized'] for r in table)!r}, planned "
        f"{sum(r['planned'] for r in table)!r}, regret sum {sum(regret)!r}, "
        f"max {max(regret)!r}, min {min(regret)!r}; finalize_tiers counts "
        f"{counts}; the first rows:\n"
        + evaluate.format_regret_table(table[:4]))
    chaos_cpu_parity(eng, summary, bills, planned)
    shutil.rmtree(directory, ignore_errors=True)
    return launches


def chaos_cpu_parity(eng, summary, bills, planned):
    """512 sampled tenants through the port's CPU run of the same chunks
    and the same outage, from the card's planned boundaries (the CPU's
    re-solve pinned to the device route, as the card's): the evacuation's
    rows, moved docs and bills, the re-plan events and the ledger rows
    bit for bit."""
    rng = np.random.default_rng(152)
    sample = np.sort(rng.choice(CH_TENANTS, CH_SAMPLE, replace=False))
    rows = np.array([eng.stream_row(int(s)) for s in sample])
    cpu = chaos_engine(device="cpu", rows=sample, planned=planned)
    cpu._replanner.backend = "device"
    t0 = time.perf_counter()
    for i in range(CH_CHUNKS):
        cpu.ingest_dense(chaos_chunk(i, rows))
    c_summary, c_bills, _, _ = outage_drill(cpu, rows)
    cpu.finalize()
    cpu_s = time.perf_counter() - t0
    keep = {int(s) for s in sample}
    sid = eng._sid_of_row
    evac_card = [sid[r] for r in summary["rows"] if sid[r] in keep]
    evac_cpu = [cpu._sid_of_row[r] for r in c_summary["rows"]]
    moved = lambda e, k: [(a["stream_id"], a["moved_docs"],  # noqa: E731
                           a["replanned"], a["position"])
                          for a in (x["attrs"] for x in e._obs.tracer.events
                                    if x["name"] == "tier_evacuation")
                          if a["stream_id"] in k]
    checks = {
        "evacuated rows": evac_card == evac_cpu,
        "moved docs": moved(eng, keep) == moved(cpu, keep),
        "bills": np.array_equal(bills[rows], c_bills),
        "replan events": [replan_key(e) for e in eng.replan_events
                          if e.stream_id in keep]
        == [replan_key(e) for e in cpu.replan_events],
    }
    full, part = eng.meter.state_dict(), cpu.meter.state_dict()
    checks["meter rows"] = all(np.array_equal(full[k][rows], part[k])
                               for k in full)
    cf, cp = eng._cost_monitor.state_dict(), cpu._cost_monitor.state_dict()
    checks["cost monitor rows"] = all(
        np.array_equal(cf[k][..., rows] if k == "hist" else cf[k][rows],
                       cp[k]) for k in cf if k != "steps")
    sf, sp = eng.cost_summary(), cpu.cost_summary()
    checks["cost_summary rows"] = all(
        np.array_equal(sf[k][rows], sp[k])
        for k in ("writes", "reads", "storage", "migration", "total",
                  "planned", "regret"))
    log(f"resilience [15b]: {CH_SAMPLE} sampled tenants through the port's "
        f"CPU run of the same chunks and outage ({cpu_s:.3f}s): "
        f"{len(evac_cpu)} evacuated, {len(cpu.replan_events)} re-plan "
        f"events; equal: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"15b differs from the CPU run: {checks}")


def graceful_drain(run):
    """15c: the serving launcher on the card with --ckpt-dir, SIGTERM
    after its first checkpoint (``run``, the launcher batch's child):
    exit 0, both lines, the obs artifacts, and the final checkpoint
    restores with the printed cursor."""
    import shutil
    from repro_torch.launch import serve
    from repro_torch.obs import Observability, ObsConfig
    from repro_torch.resilience import FleetCheckpointer
    base = DRAIN_DIR
    ckpt, obs = base / "ckpt", base / "obs"
    lines = [ln for ln in run.out.splitlines()
             if ln.startswith(("graceful shutdown", "final checkpoint"))]
    log(f"resilience [15c]: launcher {' '.join(DRAIN_ARGV)}: first "
        f"checkpoint after {run.first_s:.3f}s, SIGTERM, exit "
        f"{run.rc} after {run.wall:.3f}s (in the launcher batch): {lines}")
    if run.rc != 0 or len(lines) != 2 or \
            not (obs / "metrics.json").exists():
        raise AssertionError(f"the graceful drain failed:\n"
                             f"{run.out[-3000:]}{run.err[-3000:]}")
    chunk = int(lines[1].split(" at chunk ")[1].split()[0])
    eng, _ = serve.make_tenant_engine(8, 64, 8, (16 + 12) * 4 / 1e9,
                                      obs=Observability(ObsConfig()))
    gen = FleetCheckpointer(str(ckpt)).restore(eng)
    log(f"resilience [15c]: the final checkpoint (generation {gen}) "
        f"restores into a fresh card engine at chunk {eng.chunks_ingested} "
        f"(printed {chunk})")
    if eng.chunks_ingested != chunk:
        raise AssertionError("the final checkpoint's cursor differs")
    shutil.rmtree(base, ignore_errors=True)


def resilience(bounds, mig, batch):
    """Phase 15 (15c's launcher from ``batch``). Returns the launches of
    15a's and 15b's counted runs."""
    launches = crash_recovery(bounds, mig)
    for key, n in chaos_drill().items():
        launches[key] = launches.get(key, 0) + n
    graceful_drain(batch["15c"])
    return launches


# ---------------------------------------------------------------------------
# phase 16: fleet-axis sharding, 8 shards on one card
# ---------------------------------------------------------------------------

SHARDS = 8  # examples/million_streams.py's --devices default
SH_CHUNKS = 8  # chunks a phase 16 window (the example's 16, cut for time)
MESH_ARGV = ["--device", "cuda", "--tenants", "8", "--requests", "64",
             "--batch", "8"]  # phase 15c's reduced launcher settings


def same_plan(a, b):
    return all(np.array_equal(a[key], b[key])
               for key in ("total", "bounds", "migrate"))


def sharded_plan(mesh, plan5):
    """16a: phase 5's plan, water-filling and re-solve with the mesh
    active: plan_solve launched once a shard for each of phase 5's
    launches, the plans bit-equal to phase 5's, the sharded
    water-filling held to the host law. Returns the merged (bounds,
    migrate) and the plan_solve launches."""
    from repro_torch.core import constraints as cons
    from repro_torch.core import shp
    from repro_torch.kernels.plan_solve import ops as ps
    from repro_torch.parallel import fleet
    from repro_torch.streams import planner
    args = plan5["args"]
    cw, cr, cs, n, kv, rpw = args
    # the counted run: counter to 0, plan, read
    ps.launches = 0
    t0 = time.perf_counter()
    with fleet.use_fleet_mesh(mesh):
        plan = shp.plan_ntier_arrays(*args)
    t_solve = time.perf_counter() - t0
    n_solve = ps.launches
    bounds, mig = plan["bounds"].copy(), plan["migrate"].copy()
    desired = cons.peak_occupancy_arrays(bounds, n, kv, mig)[:, 0]
    budget = float(desired.sum()) * 0.6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grants = planner.waterfill(desired, budget, mesh=mesh)
    t_wf = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = cons.waterfill_grants(desired, budget)
    t_host = time.perf_counter() - t0
    idx, cap = plan5["idx"], plan5["cap"]
    binding = np.flatnonzero(grants < desired - 1e-9)
    sub = tuple(a[idx] for a in args)
    t0 = time.perf_counter()
    with fleet.use_fleet_mesh(mesh):
        re = shp.plan_ntier_arrays(*sub, cap=cap)
    t_resolve = time.perf_counter() - t0
    n_resolve = ps.launches - n_solve
    err = float(np.abs(grants - host).max())
    over = float(grants.sum()) / budget - 1.0
    same_set = "the same set as" if np.array_equal(binding, idx) else \
        "not the same set as"
    log(f"sharded [16a]: plan of {M} streams on {SHARDS} shards "
        f"{t_solve:.3f}s ({n_solve} plan_solve launches; phase 5 "
        f"{plan5['n_solve']}), waterfill_sharded {t_wf * 1e3:.3f} ms (96 "
        f"float64 bisection steps, per-shard sums added on shard 0; host "
        f"waterfill_grants {t_host * 1e3:.3f} ms): max |grant - host| "
        f"{err:.3e}, sum/budget - 1 = {over:.3e}, {binding.size} binding "
        f"streams ({same_set} phase 5's {idx.size}); re-solve of phase "
        f"5's {idx.size} binding streams under their grants "
        f"{t_resolve:.3f}s ({n_resolve} launches; phase 5 "
        f"{plan5['n_resolve']})")
    if not (same_plan(plan, plan5["plan"]) and same_plan(re, plan5["re"])):
        raise AssertionError("the sharded plan differs from phase 5's")
    if budget != plan5["budget"]:
        raise AssertionError("the sharded plan's hot budget differs")
    if not ((grants <= desired + 1e-9).all()
            and grants.sum() <= budget * (1 + 1e-12) + 1e-9):
        raise AssertionError("waterfill_sharded oversubscribed the budget")
    if not np.allclose(grants, host, rtol=1e-7, atol=1e-7):
        raise AssertionError("waterfill_sharded is off the host law")
    if (n_solve, n_resolve) != (SHARDS * plan5["n_solve"],
                                SHARDS * plan5["n_resolve"]):
        raise AssertionError(f"the sharded plan missed plan_solve on a "
                             f"shard: {n_solve}, {n_resolve}")
    bounds[idx], mig[idx] = re["bounds"], re["migrate"]
    return bounds, mig, n_solve + n_resolve


def sharded_specs(bounds, mig):
    """Phase 8's mixed fleet: phase 5's plan for the exact streams, the
    64 logmem tenants."""
    from repro_torch.streams import StreamSpec
    specs = [StreamSpec(stream_id=i, k=K, boundaries=tuple(b),
                        migrate=bool(g))
             for i, (b, g) in enumerate(zip(bounds.tolist(), mig.tolist()))]
    return specs + [StreamSpec(stream_id=M + j, k=LM_K, r=float(4 * LM_K),
                               engine="logmem") for j in range(LM_STREAMS)]


def sharded_engine(specs, mesh):
    """The fleet with obs on, as examples/million_streams.py builds it."""
    from repro_torch.obs import Observability, ObsConfig
    from repro_torch.streams import StreamEngine
    return StreamEngine(specs, obs=Observability(ObsConfig(residuals=False)),
                        mesh=mesh)


def engine_digest(eng):
    """What phase 16 holds bit for bit: every state leaf (the shards'
    rows gathered, padding cut), the tiers and per-tier counts
    assign_tiers gives, and the metrics snapshot."""
    out = {f"state{bi}.{name}": t.cpu().numpy()
           for bi, st in enumerate(eng.states())
           for name, t in zip(st._fields, st)}
    for bi, pair in enumerate(eng.assign_tiers()):
        if pair is not None:
            out[f"tiers{bi}"], out[f"counts{bi}"] = (pair[0].cpu().numpy(),
                                                     pair[1].cpu().numpy())
    return out, eng.obs_snapshot()["engine"]


def digest_diff(a, b):
    (da, ea), (db, eb) = a, b
    bad = [key for key in da if da[key].shape != db[key].shape
           or da[key].tobytes() != db[key].tobytes()]
    return bad + (["metrics snapshot"] if ea != eb else [])


def sharded_ingest(bounds, mig, mesh):
    """16b: the mixed fleet through ingest_chunks (meter off, obs on) on
    the mesh beside an unsharded engine over the same chunks, then a
    checkpoint at 8 shards restored onto 1 and a second window on both.
    Returns the scan and tier_assign launches of the counted run."""
    import shutil
    from repro_torch.kernels.batched_topk import ops as btk
    from repro_torch.kernels.logmem_update import ops as lm_ops
    from repro_torch.kernels.tier_assign import ops as ta
    from repro_torch.resilience import FleetCheckpointer
    rng = np.random.default_rng(16)
    first = mixed_window_chunks(rng, 0, SH_CHUNKS)
    n_chunks = len(first)
    docs = (M * CHUNK + LM_STREAMS * LM_CHUNK) * n_chunks
    specs = sharded_specs(bounds, mig)
    t0 = time.perf_counter()
    plain = sharded_engine(specs, None)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    shd = sharded_engine(specs, mesh)
    t_build_shd = time.perf_counter() - t0
    log(f"sharded [16b]: {M} exact streams + {LM_STREAMS} logmem tenants "
        f"at K={LM_K} on {SHARDS} shards of {mesh.devices[0]}: buckets "
        f"padded to {shd._pad_m} rows, {[p // SHARDS for p in shd._pad_m]} "
        f"a shard; engines built in {t_build:.3f}s (unsharded) and "
        f"{t_build_shd:.3f}s (sharded)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain.ingest_chunks(first, meter=False)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    # the counted run: counters to 0, drive, read
    btk.launches = ta.launches = lm_ops.launches = 0
    t0 = time.perf_counter()
    done = shd.ingest_chunks(first, meter=False)
    torch.cuda.synchronize()
    t_shd = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiers = shd.finalize_tiers()
    t_fin = time.perf_counter() - t0
    launches = {"batched_topk": btk.launches, "logmem_update":
                lm_ops.launches, "tier_assign": ta.launches}
    log(f"sharded [16b]: launches {launches} for {done} chunks (the "
        f"unsharded engine launches {n_chunks}, {n_chunks} and 1); "
        f"finalize_tiers {t_fin:.3f}s for {len(tiers)} streams")
    want = {"batched_topk": SHARDS * n_chunks,
            "logmem_update": SHARDS * n_chunks, "tier_assign": SHARDS}
    if launches != want:
        raise AssertionError(f"sharded launches {launches} != {want}")
    del first, tiers
    d_plain, d_shd = engine_digest(plain), engine_digest(shd)
    bad = digest_diff(d_plain, d_shd)
    log(f"sharded [16b]: {len(d_shd[0]) - len(bad)}/{len(d_shd[0])} state, "
        f"tier and count leaves and the metrics snapshot bit-equal to the "
        f"unsharded engine over the same chunks: {d_shd[1]}")
    if bad or d_shd[1]["docs"] != docs:
        raise AssertionError(f"sharded ingest differs from unsharded: {bad}")
    del plain, d_plain
    # reshard: a checkpoint written at 8 shards restored onto 1
    ckdir = ROOT / "build" / "ckpt16"
    shutil.rmtree(ckdir, ignore_errors=True)
    t0 = time.perf_counter()
    FleetCheckpointer(str(ckdir), every=0).save(shd, blocking=True)
    t_save = time.perf_counter() - t0
    back = sharded_engine(specs, None)
    t0 = time.perf_counter()
    FleetCheckpointer(str(ckdir)).restore(back)
    t_restore = time.perf_counter() - t0
    cursor = back.chunks_ingested
    bad = digest_diff(d_shd, engine_digest(back))
    if bad or cursor != done:
        raise AssertionError(f"the 8 -> 1 restore differs: {bad}")
    second = mixed_window_chunks(rng, 1, SH_CHUNKS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shd.ingest_chunks(second, meter=False)
    torch.cuda.synchronize()
    t_shd2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    back.ingest_chunks(second, meter=False)
    torch.cuda.synchronize()
    t_back2 = time.perf_counter() - t0
    del second
    bad = digest_diff(engine_digest(shd), engine_digest(back))
    log(f"sharded [16b]: checkpoint at {SHARDS} shards (blocking save "
        f"{t_save:.3f}s) restored onto 1 shard ({t_restore:.3f}s) at chunk "
        f"{cursor}, then a second window on both: "
        f"{'DIFFERENT ' + str(bad) if bad else 'bit-equal'}")
    shutil.rmtree(ckdir, ignore_errors=True)
    if bad:
        raise AssertionError(f"the resumed 1-shard engine differs: {bad}")
    log(f"sharded [16b]: ingest docs/s ({docs} docs a window; host clock "
        f"around ingest_chunks and a sync): window 1 unsharded "
        f"{docs / t_plain:.6g}, {SHARDS} shards {docs / t_shd:.6g} (ratio "
        f"{t_plain / t_shd:.4f}); window 2 {SHARDS} shards "
        f"{docs / t_shd2:.6g}, unsharded (restored) {docs / t_back2:.6g} "
        f"(ratio {t_back2 / t_shd2:.4f})")
    # where a sharded step's time goes, beside the unsharded step's
    # (the same four chunks through each engine)
    third = mixed_window_chunks(rng, 2, 4)
    for eng, label in ((shd, f"{SHARDS} shards"), (back, "unsharded")):
        step_profile(eng, third, f"the mixed fleet with obs on, {label}")
    return launches


def mesh_launcher(batch):
    """16c: the serving launcher with --mesh 2 (2 shards on the card: one
    card is visible) against the same run without it, both children of
    the launcher batch (``batch``); then serve() in this process with and
    without a 2-shard mesh, every tenant's retained set and meter
    equal."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.parallel import fleet
    outs = {}
    for label in ("mesh", "plain"):
        run = batch[f"16c {label}"]
        if run.rc:
            raise AssertionError(f"the launcher ({label}) failed:\n"
                                 f"{run.out[-2000:]}{run.err[-2000:]}")
        outs[label] = (run.out, run.wall)

    def kept(text):
        return [ln for ln in text.splitlines()
                if ln.startswith(("tenant ", "fleet ledger",
                                  "per-stream strategies"))]

    mesh_line = [ln for ln in outs["mesh"][0].splitlines()
                 if ln.startswith("fleet mesh")]
    equal = kept(outs["mesh"][0]) == kept(outs["plain"][0])
    log(f"sharded [16c]: launcher {' '.join(MESH_ARGV)} --mesh 2: "
        f"{mesh_line} ({outs['mesh'][1]:.1f}s; without --mesh "
        f"{outs['plain'][1]:.1f}s; both in the launcher batch); "
        f"{len(kept(outs['mesh'][0]))} retained "
        f"and ledger lines {'equal' if equal else 'DIFFERENT'}")
    if not (mesh_line and kept(outs["plain"][0]) and equal):
        raise AssertionError("serve --mesh 2 differs from the unsharded run")
    cfg = configs.get_config("llama3.2-1b", reduced=True)
    params = lm.init_params(cfg, seed=0, device="cuda")
    res = {}
    for label, mesh in (("mesh", fleet.fleet_mesh(2, device="cuda:0")),
                        ("plain", None)):
        res[label] = serve.serve(cfg, params, requests=64, batch=8,
                                 prompt_len=16, gen_len=12, topk=8,
                                 tenants=8, device="cuda", mesh=mesh)
    a, b = res["mesh"], res["plain"]
    same = (a.retained.keys() == b.retained.keys()
            and all(np.array_equal(a.retained[t], b.retained[t])
                    for t in a.retained)
            and all(np.array_equal(getattr(a.engine.meter, f),
                                   getattr(b.engine.meter, f))
                    for f in ("observed", "writes", "deletes", "reads")))
    log(f"sharded [16c]: serve() with a 2-shard mesh: all "
        f"{len(a.retained)} tenants' retained sets and meter ledgers "
        f"{'equal' if same else 'DIFFERENT'} to the unsharded run")
    if not same:
        raise AssertionError("serve(mesh=) differs from the unsharded run")


def sharded(bounds, mig, plan5, batch):
    """Phase 16 (16c's launchers from ``batch``). Returns its launches."""
    from repro_torch.parallel import fleet
    mesh = fleet.fleet_mesh(SHARDS, device="cuda:0")
    b16, m16, ps_launches = sharded_plan(mesh, plan5)
    if not (np.array_equal(b16, bounds) and np.array_equal(m16, mig)):
        raise AssertionError("the sharded plan's boundaries differ")
    launches = sharded_ingest(bounds, mig, mesh)
    launches["plan_solve"] = ps_launches
    mesh_launcher(batch)
    return launches


# ---------------------------------------------------------------------------
# phase 17: training with top-K curation on the card
# ---------------------------------------------------------------------------

TR_LR = 3e-4  # 17a's and 17b's learning rate
TR_FULL = dict(batch=8, seq=1024, steps=8, reservoir_k=16)  # 17b
TRAIN_DIR = ROOT / "build" / "train17d"  # 17d's checkpoints
TRAIN_ARGV = ["--arch", ARCH, "--reduced", "--steps", "40", "--seq", "512",
              "--batch", "32", "--device", "cuda"]  # 17d's launcher


def state_to(state, device):
    """A train state's tensors copied to ``device``."""
    from repro_torch.checkpoint.manager import tree_flatten, tree_unflatten
    leaves, treedef = tree_flatten(state)
    return tree_unflatten(treedef, [x.to(device, copy=True) for x in leaves])


def check_step_params(got, want, first_moment, lr, label):
    """17a's parameter tolerance (see the module docstring): the largest
    fraction of a leaf's elements that took the AdamW exception."""
    from repro_torch.optim.adamw import tree_leaves
    worst = 0.0
    for i, (a, w, m) in enumerate(zip(tree_leaves(got), tree_leaves(want),
                                      tree_leaves(first_moment))):
        a, w, m = a.double().cpu(), w.double().cpu(), m.double()
        err = (a - w).abs()
        off = err > 1e-5 * float(w.abs().max())
        free = m.abs() <= 1e-5 * float(m.abs().max())
        worst = max(worst, float(off.double().mean()))
        if float(off.double().mean()) >= 1e-3 or not bool(free[off].all()) \
                or not bool((err[off] <= 2 * lr).all()):
            raise AssertionError(f"{label}: parameter leaf {i} differs "
                                 f"from the CPU run (max abs diff "
                                 f"{float(err.max()):.3e})")
    return worst


def train_card_vs_cpu(smi):
    """17a: reduced llama3.2-1b, 3 train_steps on the card against the
    CPU, each from the CPU's state. Returns the flash launches."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import StreamLoader
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import steps
    cfg = configs.get_config(ARCH, reduced=True)
    cpu = steps.init_train_state(cfg, seed=0, reservoir_k=16, device="cpu")
    loader = StreamLoader(cfg, ShapeConfig("17a", seq_len=64, global_batch=8,
                                           kind="train"), seed=0)
    fa.launches = fa.bwd_launches = 0
    grads_taken = 0
    for step in range(3):
        card = state_to(cpu, "cuda")
        host = loader.batch_for_step(step)
        b_cpu = {k: torch.as_tensor(x) for k, x in host.items()}
        b_card = {k: torch.as_tensor(x, device="cuda") for k, x in
                  host.items()}
        _, _, g_cpu = steps.loss_and_grads(cpu.params, cfg, b_cpu)
        _, _, g_card = steps.loss_and_grads(card.params, cfg, b_card)
        grads_taken += 1
        g_worst = 0.0
        for i, (a, w) in enumerate(zip(tree_leaves(g_card),
                                       tree_leaves(g_cpu))):
            a, top = a.cpu(), float(w.abs().max())
            err = float((a - w).abs().max())
            if top == 0.0 or err > 1e-4 * top:
                raise AssertionError(f"17a step {step}: gradient leaf {i} "
                                     f"(max {top:.3e}) differs by {err:.3e}")
            g_worst = max(g_worst, err / top)
        nxt, m_cpu = steps.train_step(cpu, b_cpu, cfg, lr=TR_LR)
        card, m_card = steps.train_step(card, b_card, cfg, lr=TR_LR)
        grads_taken += 1
        rels = {}
        for key in ("loss", "per_example_nll", "grad_norm"):
            a, w = m_card[key].double().cpu(), m_cpu[key].double()
            rels[key] = float(((a - w).abs() / w.abs()).max())
            if rels[key] > 1e-5:
                raise AssertionError(f"17a step {step}: {key} differs from "
                                     f"the CPU run by {rels[key]:.3e} "
                                     f"relative")
        nll = np.sort(m_cpu["per_example_nll"].double().numpy())
        if not (np.diff(nll) > 1e-5 * np.abs(nll[1:])).all():
            raise AssertionError("17a: two NLLs of a batch lie within 1e-5")
        if not torch.equal(card.reservoir.ids.cpu(), nxt.reservoir.ids):
            raise AssertionError(f"17a step {step}: reservoir ids differ")
        frac = check_step_params(card.params, nxt.params, nxt.opt.m, TR_LR,
                                 f"17a step {step}")
        log(f"train [17a reduced {ARCH}] step {step}: loss "
            f"{float(m_card['loss']):.6f} (CPU {float(m_cpu['loss']):.6f}); "
            f"relative diffs loss {rels['loss']:.2e}, per-example NLL "
            f"{rels['per_example_nll']:.2e}, grad_norm "
            f"{rels['grad_norm']:.2e} "
            f"(limit 1e-5); gradients within {g_worst:.2e} of each leaf's "
            f"largest magnitude (limit 1e-4), every leaf non-zero; params "
            f"within 1e-5 of each leaf's largest magnitude but {frac:.2e} of "
            f"a leaf at most (AdamW's undetermined elements, within 2 lr); "
            f"reservoir ids equal")
        cpu = nxt
    want = cfg.n_layers * grads_taken
    log(f"train [17a] launches: flash_attention {fa.launches}, "
        f"flash_attention_bwd {fa.bwd_launches} (want {want} each: one a "
        f"layer a gradient)")
    if (fa.launches, fa.bwd_launches) != (want, want):
        raise AssertionError("17a launch counts are not one a layer a "
                             "gradient")
    return {"flash_attention": fa.launches,
            "flash_attention_bwd": fa.bwd_launches}


def train_full_width(smi):
    """17b: llama3.2-1b at full width, 8 train_steps from StreamLoader
    batches; then one profiled step. Returns the counted launches."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import StreamLoader
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import lm
    from repro_torch.runtime import steps
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    cfg = configs.get_config(ARCH)
    b, s, n = TR_FULL["batch"], TR_FULL["seq"], TR_FULL["steps"]
    t0 = time.perf_counter()
    state = steps.init_train_state(cfg, seed=0,
                                   reservoir_k=TR_FULL["reservoir_k"],
                                   device="cuda")
    torch.cuda.synchronize()
    log(f"train [17b {ARCH} full width]: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, "
        f"head_dim {cfg.head_dim}, vocab {cfg.vocab_size}, "
        f"{cfg.param_dtype}: {lm.param_count(cfg)} parameters drawn on the "
        f"card with their AdamW moments in {time.perf_counter() - t0:.3f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    loader = StreamLoader(cfg, ShapeConfig("17b", seq_len=s, global_batch=b,
                                           kind="train"), seed=0)
    batches = [{k: torch.as_tensor(x, device="cuda")
                for k, x in loader.batch_for_step(i).items()}
               for i in range(n + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the counted run: counters to 0, n steps, read
    fa.launches = fa.bwd_launches = 0
    losses, ms = [], []
    for i in range(n):
        t0 = time.perf_counter()
        state, met = steps.train_step(state, batches[i], cfg, lr=TR_LR)
        losses.append(float(met["loss"]))  # the step's one sync
        ms.append((time.perf_counter() - t0) * 1e3)
    counted = {"flash_attention": fa.launches,
               "flash_attention_bwd": fa.bwd_launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = cfg.n_layers * n
    med = statistics.median(ms[1:])
    log(f"train [17b] launches: {counted} (want {want} each: one a layer a "
        f"step)")
    log(f"train [17b] losses {' '.join(f'{x:.6f}' for x in losses)}; step "
        f"ms {' '.join(f'{x:.3f}' for x in ms)}; median after the first "
        f"{med:.3f} ms (min {min(ms[1:]):.3f}, max {max(ms[1:]):.3f}); "
        f"{b * s / med * 1e3:.6g} tokens/s; peak device memory {peak:.3f} "
        f"GiB (params, grads, moments and activations); grad_norm "
        f"{float(met['grad_norm']):.4f}; host clock, the loss read syncs; "
        f"{smi}")
    if counted != {"flash_attention": want, "flash_attention_bwd": want}:
        raise AssertionError(f"17b launches {counted} != {want} each")
    if not all(np.isfinite(losses)) or \
            not np.mean(losses[-2:]) < np.mean(losses[:2]):
        raise AssertionError(f"17b: losses not finite or not falling: "
                             f"{losses}")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, met = steps.train_step(state, batches[n], cfg, lr=TR_LR)
        float(met["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    profile_report(prof, f"train [17b {ARCH} step, {b} x {s}]", 1, wall, smi)
    from torch.autograd import DeviceType
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    bwd = [e for e in dev if "flash_bwd" in e.name]
    bwd_ms = sum(e.time_range.end - e.time_range.start for e in bwd) / 1e3
    log(f"train [17b] flash_attention's backward in the profiled step: "
        f"{len(bwd)} launches, {bwd_ms:.3f} ms = {bwd_ms / union_ms(dev):.4f} "
        f"of the device's busy {union_ms(dev):.3f} ms; {smi}")
    del state, met, batches, prof
    torch.cuda.empty_cache()
    return counted


class RecordingCurator:
    """A TopKCurator that also keeps the (ids, scores) stream it saw."""

    def __init__(self, curator):
        self.curator, self.ids, self.scores = curator, [], []

    def observe_batch(self, ids, scores, payloads):
        self.ids.append(np.array(ids))
        self.scores.append(np.array(scores, np.float64))
        return self.curator.observe_batch(ids, scores, payloads)


def curated_training(smi):
    """17c: examples_torch/train_topk_curation.py at its defaults on the
    card, through its ``run`` with a RecordingCurator around its curator,
    then the checks and the resume check. Returns the flash launches of
    both."""
    import shutil
    from examples_torch import train_topk_curation as e2e
    from repro_torch.core import shp, simulator
    from repro_torch.kernels.flash_attention import ops as fa
    root = ROOT / "build" / "ckpt17c"
    shutil.rmtree(root, ignore_errors=True)
    args = e2e.parse_args(["--ckpt-dir", str(root), "--device", "cuda"])
    n_docs, k = args.steps * args.batch, args.reservoir_k
    box = {}

    def wrap(curator):
        box["rec"] = RecordingCurator(curator)
        return box["rec"]

    fa.launches = fa.bwd_launches = 0
    t0 = time.perf_counter()
    res = e2e.run(args, curator_wrapper=wrap)
    wall = time.perf_counter() - t0
    rec, cfg, rep, curator = box["rec"], res.cfg, res.report, res.curator
    launches = {"flash_attention": fa.launches,
                "flash_attention_bwd": fa.bwd_launches}
    want = cfg.n_layers * args.steps
    first, last = np.mean(rep.losses[:10]), np.mean(rep.losses[-10:])
    times = [x * 1e3 for x in rep.step_times[1:]]
    log(f"train [17c lm-100m, examples_torch/train_topk_curation.py]: "
        f"{rep.steps_run} steps of {args.batch} x {args.seq}, lr "
        f"{args.lr}, reservoir_k {k}, in {wall:.3f}s (resumed from "
        f"{rep.resumed_from}, {rep.straggler_steps} straggler steps); loss "
        f"{rep.losses[0]:.4f} -> {rep.losses[-1]:.4f} (mean of the first 10 "
        f"{first:.4f}, of the last 10 {last:.4f}); step ms median "
        f"{statistics.median(times):.3f} (min {min(times):.3f}, max "
        f"{max(times):.3f}; host clock, the loss read syncs); launches "
        f"{launches} (want {want} each); checkpoints kept "
        f"{sorted(p.name for p in root.glob('ckpt_*'))}; {smi}")
    if rep.resumed_from is not None or rep.steps_run != args.steps:
        raise AssertionError("17c did not run its steps from the start")
    if launches != {"flash_attention": want, "flash_attention_bwd": want}:
        raise AssertionError(f"17c launches {launches} != {want} each")
    if not last < first:
        raise AssertionError("17c: the loss did not fall")
    # the curator against an exact replay of the stream it saw, and the
    # law on the same scores in a random order
    ids, scores = np.concatenate(rec.ids), np.concatenate(rec.scores)
    order = np.argsort(ids, kind="stable")
    if not np.array_equal(ids[order], np.arange(n_docs)):
        raise AssertionError("17c: the curator did not see every example "
                             "once")
    trace = scores[order]
    sim = simulator.simulate(trace, k, res.policy)
    stats = curator.stats
    analytic = float(shp.expected_cum_writes(n_docs - 1, k))
    survivors = curator.survivor_ids()
    ledger = int(res.store.ledger.writes.sum())
    log(f"train [17c] curation {stats.as_dict()}; ledger writes {ledger}; "
        f"core.simulator replay of the same NLL stream: writes "
        f"{int(sim.writes_per_tier.sum())}, survivors equal "
        f"{np.array_equal(np.sort(survivors), np.sort(sim.survivor_ids))}; "
        f"eq. 11/12 expects {analytic:.1f} writes for a random order: "
        f"in-order {stats.writes / analytic:.4f} of it")
    if stats.writes != ledger or stats.writes != int(
            sim.writes_per_tier.sum()) or not np.array_equal(
            np.sort(survivors), np.sort(sim.survivor_ids)):
        raise AssertionError("17c: the curator's writes or survivors differ "
                             "from its ledger or the simulator replay")
    perm = np.random.default_rng(17).permutation(n_docs)
    _, _, _, shuffled = e2e.setup(args, "cuda")
    payload = np.zeros((args.batch, args.seq), np.int32)
    for off in range(0, n_docs, args.batch):
        shuffled.observe_batch(np.arange(off, off + args.batch),
                               trace[perm[off:off + args.batch]], payload)
    ratio = abs(shuffled.stats.writes - analytic) / analytic
    log(f"train [17c] the same {n_docs} NLLs in a random order: "
        f"{shuffled.stats.writes} writes, {ratio:.4f} off eq. 11/12's "
        f"{analytic:.1f} (limit 0.35, tests/test_train_loop.py:91); ledger "
        f"writes {int(shuffled.store.ledger.writes.sum())}")
    if ratio >= 0.35 or shuffled.stats.writes != int(
            shuffled.store.ledger.writes.sum()):
        raise AssertionError("17c: a random-order stream misses the write "
                             "law")
    shutil.rmtree(root, ignore_errors=True)
    for key, n in resume_check(cfg, res.loader, args.lr).items():
        launches[key] += n
    return launches


def resume_check(cfg, loader, lr):
    """8 straight steps against 4 steps and 4 resumed from the checkpoint,
    bit for bit, under torch.use_deterministic_algorithms(True)."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop
    dirs = [ROOT / "build" / f"ckpt17c_{x}" for x in "ab"]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    def loop(n):
        return train_loop.LoopConfig(total_steps=n, ckpt_every=4, lr=lr)
    fa.launches = fa.bwd_launches = 0
    torch.use_deterministic_algorithms(True)
    try:
        a = train_loop.run(cfg, loader, loop=loop(8), device="cuda",
                           ckpt=CheckpointManager(str(dirs[0])))
        mgr = CheckpointManager(str(dirs[1]))
        b1 = train_loop.run(cfg, loader, loop=loop(4), ckpt=mgr,
                            device="cuda")
        b2 = train_loop.run(cfg, loader, loop=loop(8), ckpt=mgr,
                            device="cuda")
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(x, y) for x, y in zip(
        adamw.tree_leaves(a.final_state.params),
        adamw.tree_leaves(b2.final_state.params)))
    same_opt = all(torch.equal(x, y) for x, y in zip(
        adamw.tree_leaves(a.final_state.opt.v),
        adamw.tree_leaves(b2.final_state.opt.v)))
    same_res = torch.equal(a.final_state.reservoir.ids,
                           b2.final_state.reservoir.ids)
    log(f"train [17c resume] 8 straight steps vs 4 + 4 resumed (from step "
        f"{b2.resumed_from}), torch.use_deterministic_algorithms(True): "
        f"losses of steps 5-8 equal {a.losses[4:] == b2.losses} "
        f"({' '.join(f'{x:.7f}' for x in b2.losses)}); params bit-equal "
        f"{same}, second moments {same_opt}, reservoir ids {same_res}")
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    if not (b1.steps_run == 4 and b2.resumed_from == 4
            and a.losses[4:] == b2.losses and same and same_opt and same_res):
        raise AssertionError("17c: the resumed run differs from the "
                             "straight one")
    return {"flash_attention": fa.launches,
            "flash_attention_bwd": fa.bwd_launches}


def train_drain(run):
    """17d: the training launcher on the card, SIGTERM once its first
    checkpoint is on disk (``run``, the launcher batch's child)."""
    import shutil
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import steps
    d = TRAIN_DIR
    lines = run.out.strip().splitlines()
    log(f"train [17d] {' '.join(run.argv[1:])}: first checkpoint after "
        f"{run.first_s:.3f}s, SIGTERM sent; exit {run.rc} after "
        f"{run.wall:.3f}s (in the launcher batch); last lines: "
        f"{' | '.join(lines[-2:])}")
    if run.rc != 0 or not lines or \
            not lines[-1].startswith("stopped by a signal at step "):
        raise AssertionError(f"17d: the launcher did not drain: exit "
                             f"{run.rc}\n{run.out}\n{run.err[-2000:]}")
    step = int(lines[-1].split("at step ")[1].split()[0])
    mgr = CheckpointManager(str(d))
    cfg = configs.get_config(ARCH, reduced=True)
    state = mgr.restore(steps.init_train_state(cfg, device="cuda"))
    newest = mgr.latest_step()
    log(f"train [17d] stopped at step {step}; newest checkpoint step "
        f"{newest}, restored state step {int(state.step)}")
    shutil.rmtree(d, ignore_errors=True)
    if not (20 <= step < 40 and newest == step and int(state.step) == step):
        raise AssertionError("17d: the final checkpoint does not restore at "
                             "the printed step")


def training(smi, batch):
    """Phase 17 (17d's launcher from ``batch``). Returns the flash
    launches of its counted runs."""
    launches = train_card_vs_cpu(smi)
    for part in (train_full_width(smi), curated_training(smi)):
        for key, n in part.items():
            launches[key] += n
    train_drain(batch["17d"])
    return launches


# ---------------------------------------------------------------------------
# phase 18: the SSM and hybrid score producers at full width
# ---------------------------------------------------------------------------

def decode_vs_forward(params, cfg, prompts, label, steps=DECODE_CHECK,
                      extra=None):
    """Prefill the batch's ``P`` prompt tokens, decode ``steps`` more (the
    SSD recurrence from the carried states; hymba's rolling 1024-slot
    caches wrapped by the prefill), and hold the prefill's and each
    step's logits to ``lm.forward``'s at that position over P + steps
    tokens (the chunked scan; flash_attention in the forward):
    |decode - forward| <= 2e-3 |forward| + 3e-4 scale, tests/test_decode.py's
    rtol and atol with the atol scaled by ``scale``, the largest |logit|
    of the checked positions. ``extra``: the batch's other model inputs
    (``frames`` or ``patch_embeds``), given to the forward and the
    prefill."""
    from repro_torch.models import lm
    b, p = prompts.shape
    extra = extra or {}
    g = torch.Generator(device="cuda").manual_seed(18)
    more = torch.randint(0, cfg.vocab_size, (b, steps), device="cuda",
                         generator=g)
    full, _ = lm.forward(params, cfg, {"tokens": torch.cat([prompts, more],
                                                           1), **extra})
    want = full[:, p - 1:].clone()  # positions P-1 .. P+steps-1
    del full
    cache = lm.init_cache(cfg, b, p + steps + 1, device="cuda",
                          enc_len=enc_len_of(extra))
    logits, cache = lm.prefill(params, cfg, {"tokens": prompts, **extra},
                               cache)
    got = [logits]
    for t in range(steps):
        logits, cache = lm.decode_step(params, cfg, more[:, t], cache)
        got.append(logits)
    got = torch.stack(got, 1)
    scale = float(want.abs().max())
    diff = (got - want).abs()
    worst = float((diff - 2e-3 * want.abs()).max())
    per_step = " ".join(f"{float(d.max()):.3e}" for d in diff.unbind(1))
    rolled = [len(lc["kv"].pos[0]) for grp in cache["groups"]
              for lc in grp if "kv" in lc]
    log(f"decode vs forward [{label}]: prefill of {b} x {p}, then {steps} "
        f"decode steps against lm.forward over {p + steps} tokens: max abs "
        f"diff per position (prefill first) {per_step}; largest excess over "
        f"2e-3 |forward| {worst:.3e} (limit 3e-4 x {scale:.3f} = "
        f"{3e-4 * scale:.3e}); KV cache slots per attention layer "
        f"{sorted(set(rolled)) or 'none'}; cache position {cache['pos']}")
    if not (torch.isfinite(got).all() and worst <= 3e-4 * scale):
        raise AssertionError(f"decode differs from the forward [{label}]")


def ssm_serve(smi, arch, sub):
    """Phase 18a/b: ``arch`` at full width with random weights from a
    seeded torch.Generator on the card: the first batch teacher-forced
    through both routes, decode against the forward, one counted
    single-tenant serve run whose launches must be exact, the retained
    set against the top-K of the scores, peak memory, then the profiles
    (with the SSD scan's share of a prefill). Returns the launches."""
    from repro_torch import configs
    from repro_torch.kernels.entropy_scores import ops as ent
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import serve
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()  # the previous phase's blocks
    cfg = configs.get_config(arch)
    run = SSM_SERVE[arch]
    label = f"{sub} {arch}"
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    mixers = ", ".join(f"{s.count} {s.mixer}"
                       + (f" (window {s.window_list()[0]})"
                          if any(s.window_list()) else "")
                       for s in cfg.layers)
    attn = (f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, head_dim "
            f"{cfg.head_dim}, d_ff {cfg.d_ff} {cfg.ffn_act}, "
            if attention_layers(cfg) else "no attention, no FFN, ")
    log(f"serve [{label}]: full width ({cfg.n_layers} layers: {mixers}; "
        f"d_model {cfg.d_model}, SSD {cfg.ssm_heads} heads of "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, "
        f"conv width {cfg.ssm_conv_width}, {attn}vocab {cfg.vocab_size}, "
        f"tied embeddings {cfg.tie_embeddings}, {cfg.param_dtype}): "
        f"{lm.param_count(cfg)} parameters drawn on the card in "
        f"{time.perf_counter() - t0:.3f}s; TF32 off; {smi}")
    b, plen = run["batch"], run["prompt_len"]
    first = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, plen)), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    teacher_forced(params, cfg, first, run["gen_len"])
    decode_vs_forward(params, cfg, first, label)
    checks_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    # the counted run: counters to 0, serve, read
    fa.launches = ent.launches = 0
    res = serve.serve(cfg, params, tenants=1, device="cuda", **run)
    launches = check_serve(res, cfg, run, f"{label}, single tenant", smi)
    order = np.lexsort((np.arange(run["requests"]), -res.scores))
    want = sorted(order[:run["topk"]].tolist())
    log(f"serve [{label}]: scores "
        f"{' '.join(f'{x:.7g}' for x in res.scores)}; retained "
        f"{res.retained}, top-{run['topk']} of the scores (ties to the "
        f"lower id) {want}; curation {res.curator.stats.as_dict()}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
        f"in the serve run, {checks_peak:.3f} GiB in the checks before it "
        f"(the plain route's attention included); {smi}")
    if res.retained != want:
        raise AssertionError("retained set is not the top-K of the scores")
    serve_profile(params, cfg, first, smi)
    return launches


def ssm_hybrid(smi):
    """Phase 18: mamba2-2.7b (18a) and hymba-1.5b (18b) served at full
    width. Returns the launches of flash_attention and entropy_scores
    summed over the two counted serve runs."""
    launches = {"flash_attention": 0, "entropy_scores": 0}
    for sub, arch in (("18a", MB_ARCH), ("18b", HY_ARCH)):
        with phase_clock(f"{arch} at full width (phase {sub})"):
            for key, n in ssm_serve(smi, arch, sub).items():
                launches[key] += n
    return launches


# ---------------------------------------------------------------------------
# phase 19: the MoE score producer at full width
# ---------------------------------------------------------------------------

class RouteLog:
    """While active, records each ``ffn.moe_route`` call's router
    probabilities, route and capacity, in call order (on the device; no
    synchronization)."""

    def __enter__(self):
        from repro_torch.models import ffn
        self.calls, self.orig = [], ffn.moe_route

        def capture(probs, top_k, capacity, renorm):
            route = self.orig(probs, top_k, capacity, renorm)
            self.calls.append((probs, route, capacity))
            return route

        ffn.moe_route = capture
        return self

    def __exit__(self, *exc):
        from repro_torch.models import ffn
        ffn.moe_route = self.orig


def route_margin(probs, ea, eb):
    """For n tokens whose choices differ between two routes, from the
    first route's router probabilities (n, E) and each route's choices
    (n, k): the gap between the router logits of the two experts at the
    first rank where the choices differ (log-probabilities differ by the
    logits' differences), over that token's own range of logits."""
    lp = torch.log(probs.clamp_min(1e-38))
    j = (ea != eb).int().argmax(-1, keepdim=True)  # the first such rank
    gap = (lp.gather(-1, ea.gather(-1, j))
           - lp.gather(-1, eb.gather(-1, j))).abs()[:, 0]
    return gap / (lp.amax(-1) - lp.amin(-1))


def moe_teacher_forced(params, cfg, prompts, gen):
    """``teacher_forced`` for a model with MoE layers: the kernel route and
    the plain route (fed the kernel route's tokens) each record every
    layer's routing. Where a token's own choices differ between the
    routes (a near-tie moved by the attention's ~1e-6), the gap between
    the two experts' router logits at the first rank where they differ
    must be below 1e-4 of that token's range of logits; a token whose
    slots or dispatch differ while its choices agree must share its group
    with such a token (slots are handed out in token order). A batch row
    with a token whose experts or dispatch differed (its output differs)
    is left out of every later comparison, and at least half of the rows
    must be left after the last step. The logits and scores of the rows
    left are held to teacher_forced's limits; the rest are counted."""
    from repro_torch.launch import serve
    n_moe = sum(s.count for s in cfg.layers if s.ffn == "moe")
    b_rows, s_len = prompts.shape
    with RouteLog() as ra:
        a = serve.generate(params, cfg, prompts, gen, keep_logits=True)
    with RouteLog() as rb:
        b = serve.generate(params, cfg, prompts, gen, use_kernel=False,
                           forced=a.tokens, keep_logits=True)
    if not len(ra.calls) == len(rb.calls) == n_moe * gen:
        raise AssertionError(f"{len(ra.calls)} and {len(rb.calls)} routed "
                             f"MoE calls, not {n_moe * gen}")
    bad = torch.zeros(b_rows, dtype=torch.bool, device=prompts.device)
    ok_at, flips, worst = [], 0, 0.0
    for pos in range(gen):
        for layer in range(n_moe):
            pa, ra_, cap = ra.calls[pos * n_moe + layer]
            _, rb_, _ = rb.calls[pos * n_moe + layer]
            own = (ra_.experts != rb_.experts).any(-1)  # (G, g)
            sent = (ra_.sent != rb_.sent).any(-1)
            slots = (ra_.slots != rb_.slots).any(-1)
            # token -> batch row: prefill's tokens run row-major, a
            # decode step routes one token a row
            rows = (torch.arange(own.numel(), device=own.device)
                    // (s_len if pos == 0 else 1)).reshape(own.shape)
            fresh = own & ~bad[rows]  # flips in rows still compared
            if bool(fresh.any()):
                ratio = route_margin(pa[fresh], ra_.experts[fresh],
                                     rb_.experts[fresh])
                m = float(ratio.max())
                worst = max(worst, m)
                flips += int(fresh.sum())
                log(f"teacher-forced [{cfg.name}] routing: position {pos}, "
                    f"MoE layer {layer}: {int(fresh.sum())} token(s) chose "
                    f"other experts on the two routes, largest router-logit "
                    f"gap at the first differing rank {m:.3e} of the "
                    f"token's range of logits (limit 1e-4)")
                if m >= 1e-4:
                    raise AssertionError("a routing difference at a margin "
                                         "that is no near-tie")
            if bool(((sent | slots).any(-1) & ~own.any(-1)).any()):
                raise AssertionError("slots differ in a group where no "
                                     "token's choices differ")
            bad[rows[own | sent]] = True
        ok_at.append(~bad)
    ok0, okn = ok_at[0], ok_at[-1]
    log(f"teacher-forced [{cfg.name}] routing: rows compared {int(ok0.sum())}"
        f" of {b_rows} after the prefill, {int(okn.sum())} after the last "
        f"step (at least {-(-b_rows // 2)} wanted); {flips} token "
        f"choice(s) moved at near-ties, the largest gap {worst:.3e} of a "
        f"token's range of logits")
    if 2 * int(okn.sum()) < b_rows:
        raise AssertionError("fewer than half of the rows' routing agreed "
                             "through the last step")
    d_pre = float((a.logits[0] - b.logits[0]).abs()[ok0].max())
    d_dec = max(float((x - y).abs()[ok].max()) for x, y, ok in
                zip(a.logits[1:], b.logits[1:], ok_at[1:]))
    d_sc = float((a.scores - b.scores).abs()[okn].max())
    agree = float((a.tokens == b.tokens).float().mean())
    scale = float(a.logits[0].abs().max())
    log(f"teacher-forced [{cfg.name}], first batch ({b_rows} x {s_len} "
        f"prompt tokens, {gen} generated): kernel route vs plain route on "
        f"the card, on the rows compared: prefill logits max abs diff "
        f"{d_pre:.3e}, decode logits {d_dec:.3e} (limit 1e-3; logits up to "
        f"{scale:.3f}), scores {d_sc:.3e} (limit 1e-4; scores near "
        f"{float(a.scores.mean()):.4f}); argmax agrees in {agree:.4f} of "
        f"{a.tokens.numel()} steps")
    if not (d_pre <= 1e-3 and d_dec <= 1e-3 and d_sc <= 1e-4):
        raise AssertionError("kernel route differs from the plain route "
                             "beyond the stated tolerance")


def dropped_shares(calls, prefill_cap):
    """Shares of token-choices past capacity, at prefill (routes of
    ``prefill_cap`` slots) and at decode (the rest)."""
    out = {}
    for key, pick in (("prefill", lambda c: c == prefill_cap),
                      ("decode", lambda c: c != prefill_cap)):
        n = sum(r.slots.numel() for _, r, c in calls if pick(c))
        dropped = sum(int((r.slots >= c).sum()) for _, r, c in calls
                      if pick(c))
        out[key] = (dropped, n)
    return out


def expert_demand(calls, prefill_cap, n_moe, n_experts):
    """The prefill's routes (those of ``prefill_cap`` slots) by MoE layer:
    each expert's share of the layer's token-choices (1 / n_experts each
    for a balanced router), and each group's demand on its busiest
    expert; the choices past capacity are sum(max(0, demand - capacity))
    over experts and groups. Returns the text and that sum over the
    layers."""
    pre = [r for _, r, c in calls if c == prefill_cap]
    lines, total = [], 0
    for layer in range(n_moe):
        demand = torch.cat([torch.nn.functional.one_hot(
            r.experts, n_experts).sum((1, 2)) for r in pre[layer::n_moe]])
        share = demand.sum(0) / demand.sum()
        busiest = demand.amax(-1)
        past = int((demand - prefill_cap).clamp_min(0).sum())
        total += past
        lines.append(
            f"MoE layer {layer}: experts' shares of the choices "
            f"{' '.join(f'{x:.4f}' for x in share.tolist())}; the busiest "
            f"expert of a group asks for {int(busiest.min())}-"
            f"{int(busiest.max())} slots (median "
            f"{int(busiest.median())}) of {prefill_cap}; {past} choices "
            f"past capacity over {demand.shape[0]} groups")
    return "; ".join(lines), total


def moe_serve(smi):
    """Phase 19: grok-1-314b at full width with its depth cut to GK_LAYERS
    of its 64 identical attn + moe layers, random weights from a seeded
    torch.Generator on the card: the first batch teacher-forced through
    both routes with the routing compared (``moe_teacher_forced``),
    decode against the forward at the dropless capacity on GK_DECODE,
    one counted single-tenant serve run whose launches must be exact,
    the retained set against the top-K of the scores, the shares of
    token-choices dropped and each expert's demand at prefill, peak
    memory, then the profiles (with the device spans of the MoE's parts
    and their share of a prefill and of a decode step). Returns the
    launches."""
    from repro_torch import configs
    from repro_torch.configs.base import LayerSpec
    from repro_torch.kernels.entropy_scores import ops as ent
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import serve
    from repro_torch.models import ffn
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()  # the previous phases' blocks
    held = torch.cuda.memory_allocated() / 2**30
    full = configs.get_config(GK_ARCH)
    cfg = full.replace(layers=(LayerSpec(count=GK_LAYERS, mixer="attn",
                                         ffn="moe"),))
    run = GK_SERVE
    label = f"19 {GK_ARCH}"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    router = params["dec"][0][0]["ffn"]["router"]
    log(f"serve [{label}]: full width, depth cut to {cfg.n_layers} of "
        f"{full.n_layers} identical attn + moe layers (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, head_dim "
        f"{cfg.head_dim}, attention logit soft-cap {cfg.attn_logit_softcap}, "
        f"{cfg.n_experts} experts of d_ff {cfg.d_ff_expert}, top-"
        f"{cfg.top_k_experts}, groups of {cfg.moe_group_size}, capacity "
        f"factor {cfg.capacity_factor}, renormalised gates "
        f"{cfg.router_scale}, vocab {cfg.vocab_size}, tied embeddings "
        f"{cfg.tie_embeddings}, head soft-cap {cfg.logit_softcap}, "
        f"{cfg.param_dtype}): {lm.param_count(cfg)} parameters (the whole "
        f"model {lm.param_count(full)}) drawn on the card in "
        f"{time.perf_counter() - t0:.3f}s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB while drawn "
        f"({held:.3f} GiB held by earlier phases); router {router.dtype}; "
        f"TF32 off; {smi}")
    if router.dtype != torch.float32:
        raise AssertionError("the router is not float32")
    b, plen = run["batch"], run["prompt_len"]
    first = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, plen)), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    moe_teacher_forced(params, cfg, first, run["gen_len"])
    rows, p = GK_DECODE
    free = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k_experts)
    decode_vs_forward(params, free, first[:rows, :p].contiguous(),
                      f"{label}, dropless capacity factor "
                      f"{free.capacity_factor}")
    checks_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    # the counted run: counters to 0, serve, read
    fa.launches = ent.launches = 0
    with RouteLog() as routes:
        res = serve.serve(cfg, params, tenants=1, device="cuda", **run)
    launches = check_serve(res, cfg, run, f"{label}, single tenant", smi)
    order = np.lexsort((np.arange(run["requests"]), -res.scores))
    want = sorted(order[:run["topk"]].tolist())
    cap = ffn._capacity(cfg.moe_group_size, cfg.top_k_experts,
                        cfg.n_experts, cfg.capacity_factor)
    shares = dropped_shares(routes.calls, cap)
    demand, past = expert_demand(
        routes.calls, cap, sum(s.count for s in cfg.layers if s.ffn == "moe"),
        cfg.n_experts)
    dec_cap = ffn._capacity(b, cfg.top_k_experts, cfg.n_experts,
                            cfg.capacity_factor)
    log(f"serve [{label}]: scores "
        f"{' '.join(f'{x:.7g}' for x in res.scores)}; retained "
        f"{res.retained}, top-{run['topk']} of the scores (ties to the "
        f"lower id) {want}; curation {res.curator.stats.as_dict()}; "
        f"token-choices dropped past capacity: prefill "
        f"{shares['prefill'][0]} of {shares['prefill'][1]} = "
        f"{shares['prefill'][0] / shares['prefill'][1]:.4f} ({cap} slots an "
        f"expert and group of {cfg.moe_group_size}), decode "
        f"{shares['decode'][0]} of {shares['decode'][1]} = "
        f"{shares['decode'][0] / shares['decode'][1]:.4f} ({dec_cap} slots "
        f"an expert for a step's {b} tokens); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB in the serve "
        f"run, {checks_peak:.3f} GiB in the checks before it (the plain "
        f"route's attention included); {smi}")
    log(f"serve [{label}] prefill demand: {demand}")
    del routes
    if past != shares["prefill"][0]:
        raise AssertionError(f"{past} choices past capacity, but "
                             f"{shares['prefill'][0]} dropped")
    if res.retained != want:
        raise AssertionError("retained set is not the top-K of the scores")
    serve_profile(params, cfg, first, smi)
    return launches


# ---------------------------------------------------------------------------
# flash_attention against another tree's (python3 chip_smoke.py --fa-ab SRC)
# ---------------------------------------------------------------------------

# (label, (B, S, H, KV, hd, hd_v), window, softcap): the serve shapes whose
# uncapped times FA_RECORDED holds, grok-1's capped and uncapped, and
# deepseek-v2's at MLA's head dims (192, 128)
FA_AB = (("llama3.2-1b", (*FA_PATH, FA_PATH[4]), 0, 0.0),
         ("starcoder2-3b", (*FA_SC, FA_SC[4]), 0, 0.0),
         ("hymba-1.5b", (*FA_HY, FA_HY[4]), HY_WINDOW, 0.0),
         ("grok-1", (*FA_GK, FA_GK[4]), 0, 0.0),
         ("grok-1 capped", (*FA_GK, FA_GK[4]), 0, GK_CAP),
         ("deepseek-v2", (*FA_DS[:3], FA_DS[2], *FA_DS[3:]), 0, 0.0))
# (label, (B, Sq, Skv, H, KV, hd, hd_v), causal, softcap): the backward at
# phase 4's training shapes: the two serve shapes, deepseek-v2's at MLA's
# head dims, grok-1's capped and whisper-base's encoder and training
# cross-attention (non-causal)
FA_AB_BWD = (
    ("llama3.2-1b backward", (*FA_PATH[:2], *FA_PATH[1:], FA_PATH[4]), True,
     0.0),
    ("starcoder2-3b backward", (*FA_SC[:2], *FA_SC[1:], FA_SC[4]), True,
     0.0),
    ("deepseek-v2 backward", (*FA_DS[:2], FA_DS[1], FA_DS[2], FA_DS[2],
                              *FA_DS[3:]), True, 0.0),
    ("grok-1 capped backward", (*FA_GK[:2], *FA_GK[1:], FA_GK[4]), True,
     GK_CAP),
    ("whisper-base encoder backward", (*FA_WH_ENC, FA_WH_ENC[5]), False,
     0.0),
    ("whisper-base cross backward", (*FA_WH_CROSS_TRAIN,
                                     FA_WH_CROSS_TRAIN[5]), False, 0.0))


def forward_gap(q, k, v, out, kw, plain=None):
    """How far a float32 forward's output ``out`` and the float32 plain
    version's (``plain`` where the caller has it, else computed) lie from
    the float64 plain version on the same inputs, one batch row at a
    time: each's largest absolute difference over the float64 output's
    largest magnitude, (out's, the plain version's)."""
    from repro_torch.kernels.flash_attention import ops as fa
    diff, top = [0.0, 0.0], 0.0
    for i in range(q.shape[0]):
        row = [x[i:i + 1] for x in (q, k, v)]
        o64 = fa.reference(*(x.double() for x in row), **kw)
        top = max(top, float(o64.abs().max()))
        ref = (plain[i:i + 1] if plain is not None
               else fa.reference(*row, **kw))
        for j, o in enumerate((out[i:i + 1], ref)):
            diff[j] = max(diff[j], float((o.double() - o64).abs().max()))
    return [d / max(top, 1e-300) for d in diff]


def fa_child(src, path, what="ab"):
    """``--fa-child SRC PATH [mla]``: flash_attention of the repro_torch
    under SRC (built there) at FA_AB, and its backward (``ops.backward``)
    at FA_AB_BWD (v and dO at its hd_v, its mask and cap; O and lse from
    the plain version), on float32 inputs from a fixed seed; each
    output's
    sha256 (the backward's dq, dk and dv together), its device ms (CUDA
    events, median of WINDOWS means of 10 calls) and its distance from the
    float64 plain route beside the float32 plain route's (``forward_gap``;
    the backward's ``f64_distances``) written to PATH as JSON. With
    ``mla``, a turn of ``--fa-layouts`` instead: the forward and the
    backward at FA_BWD_MLA's first case, each one's ms (median of WINDOWS
    means of 3 calls), the forward's largest difference from the plain
    version (relative and absolute, the limit's form) and the backward's
    from reference_backward over the largest magnitude, each of dq, dk
    and dv."""
    sys.path.insert(0, src)
    from repro_torch.kernels.flash_attention import ops as fa
    g = torch.Generator(device="cuda").manual_seed(20)
    got = {}
    if what == "mla":
        _, b, sq, skv, h, kvh, hd, hd_v, *_ = FA_BWD_MLA[0]
        q, k, v, dout = bwd_inputs(g, b, sq, skv, h, kvh, hd, hd_v,
                                   torch.float32)
        out, lse = fa.forward_with_lse(q, k, v)
        want = fa.reference(q, k, v)
        fwd_err = float(((out - want).abs() / (1 + want.abs())).max())
        del want
        ms = [statistics.median(cuda_ms(call, 3) for _ in range(WINDOWS))
              for call in (lambda: fa.flash_attention(q, k, v),
                           lambda: fa.backward(q, k, v, out, lse, dout))]
        err = [float((a - r).abs().max() / r.abs().max()) for a, r in
               zip(fa.backward(q, k, v, out, lse, dout),
                   fa.reference_backward(q, k, v, out, lse, dout))]
        Path(path).write_text(json.dumps({"ms": ms, "fwd_err": fwd_err,
                                          "err": err}))
        return 0

    def record(label, call, gap):
        ms = statistics.median(cuda_ms(call, 10) for _ in range(WINDOWS))
        outs = call()
        outs = outs if isinstance(outs, tuple) else (outs,)
        digest = hashlib.sha256(b"".join(
            x.cpu().numpy().tobytes() for x in outs)).hexdigest()
        got[label] = (digest, ms, gap(outs))

    for label, (b, s, h, kvh, hd, hd_v), window, cap in FA_AB:
        q, k, v = fa_inputs(g, b, s, s, h, kvh, hd, torch.float32)
        if hd_v != hd:
            v = torch.randn((b, s, kvh, hd_v), device="cuda", generator=g)
        kw = dict(window=window, softcap=cap)
        record(label, lambda: fa.flash_attention(q, k, v, **kw),
               lambda outs: [[x] for x in forward_gap(q, k, v, outs[0],
                                                      kw)])
    for label, (b, sq, skv, h, kvh, hd, hd_v), causal, cap in FA_AB_BWD:
        q, k, v = fa_inputs(g, b, sq, skv, h, kvh, hd, torch.float32)
        if hd_v != hd:
            v = torch.randn((b, skv, kvh, hd_v), device="cuda", generator=g)
        dout = torch.randn((b, sq, h, hd_v), device="cuda", generator=g)
        kw = dict(causal=causal, softcap=cap)
        # O and lse from the plain version, the same in both trees, so
        # that the backward's bits tell its own arithmetic apart
        out, lse = fa.reference(q, k, v, **kw), fa.reference_lse(q, k, v,
                                                                 **kw)
        record(label, lambda: fa.backward(q, k, v, out, lse, dout, **kw),
               lambda outs: f64_distances(q, k, v, dout, outs, kw))
        del q, k, v, dout, out, lse
    Path(path).write_text(json.dumps(got))
    return 0


def fa_ab(parent_src, smi):
    """``--fa-ab SRC``: this tree's flash_attention against the one under
    SRC (a parent commit's src/, unpacked with git archive) at FA_AB and
    its backward at FA_AB_BWD, in turns (SRC, this, this, SRC), each turn
    its own process: each side's two medians and both trees' distances
    from the float64 plain route (the float32 plain route's beside)
    logged, and whether each output is bit-equal to SRC's; each tree's
    two turns must be bit-equal, and no forward or backward of this tree
    slower than SRC's (the mean of each side's two medians) beyond SRC's
    spread between its turns or 1%. Where an output differs from SRC's
    (a change of arithmetic, said in the log), its distance from float64
    (the backward's: each of dq, dk and dv) must be at most FA_F64_RATIO
    times the float32 plain route's."""
    runs = []
    for i, src in enumerate((parent_src, str(ROOT / "src"),
                             str(ROOT / "src"), parent_src)):
        path = ROOT / "build" / f"fa_ab_{i}.json"
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--fa-child", src, str(path)], check=True,
                        timeout=900)
        runs.append(json.loads(path.read_text()))
        path.unlink()

    def text(gap):
        return ", ".join(f"{x:.3e}" for x in gap)

    for label, *_ in FA_AB + FA_AB_BWD:
        same = [runs[0][label][0] == runs[3][label][0],
                runs[1][label][0] == runs[2][label][0]]
        ms = [r[label][1] for r in runs]
        (parent, plain), (this, _) = (runs[i][label][2] for i in (0, 1))
        log(f"fa-ab [{label}]: ms parent {ms[0]:.4f} / {ms[3]:.4f}, this "
            f"tree {ms[1]:.4f} / {ms[2]:.4f} (CUDA events, median of "
            f"{WINDOWS} means of 10 calls); from the float64 plain route "
            f"(the output, or dq, dk, dv and the key-bias residue, over "
            f"the largest float64 magnitude): parent {text(parent)}, this "
            f"tree {text(this)}, float32 plain route {text(plain)}; each "
            f"tree's two turns bit-equal {same[0]} / {same[1]}; {smi}")
        if not all(same):
            raise AssertionError(f"fa-ab [{label}]: a tree's two turns "
                                 f"differ")
        fwd = label in dict((x[0], x) for x in FA_AB)
        what = "forward" if fwd else "backward"
        if runs[0][label][0] == runs[1][label][0]:
            log(f"fa-ab [{label}]: the {what}'s output bit-equal to SRC's")
        else:  # the output, or the worst of dq, dk and dv
            ratio = max(x / max(y, 1e-300) for x, y in zip(this[:3],
                                                          plain[:3]))
            log(f"fa-ab [{label}]: the {what}'s output differs from SRC's "
                f"(a change of arithmetic); this tree's distance from "
                f"float64 {ratio:.3g} times the float32 plain route's "
                f"(limit {FA_F64_RATIO:g})")
            if ratio > FA_F64_RATIO:
                raise AssertionError(f"fa-ab [{label}]: the {what} lies "
                                     f"{ratio:.3g} times as far from float64 "
                                     f"as the float32 plain route")
        # no slower than SRC beyond SRC's own spread between its two
        # turns, or 1% (phase 4's rule for the forward with the
        # log-sum-exp): the same code measured twice differs by that much
        this_ms, src_ms = (ms[1] + ms[2]) / 2, (ms[0] + ms[3]) / 2
        slack = max(abs(ms[0] - ms[3]), 0.01 * src_ms)
        log(f"fa-ab [{label}]: the {what} {this_ms:.4f} ms against SRC's "
            f"{src_ms:.4f} (limit {src_ms + slack:.4f}: SRC's spread or 1%)")
        if this_ms > src_ms + slack:
            raise AssertionError(f"fa-ab [{label}]: this tree's {what} is "
                                 f"slower than SRC's")
    return 0


# the launch layouts at MLA's (192, 128) for ``--fa-layouts``: (label,
# [(file under kernels/flash_attention/, text, its replacement)]), the
# built layouts first. The forward's (FwdShape in the .cu; ops.FWD_LAYOUTS
# mirrors its tiles, stages and slots): two consumer warpgroups of 64
# query rows hold Q's fragments and O in registers; what is left to choose
# is the key tile (32 keys in two stages fit the 227 KB a block may have
# beside one TMA slot), O's promoted chunk, and the N of P V's products
# (two halves of 64, so that their accumulator fits beside Q and O). The
# backward's (Shape in the .cuh and ops.BWD_LAYOUTS in step): a block
# holds 64 resident rows in two consumer warpgroups' registers; what is
# left to choose is the streamed tile's rows, the promoted chunk of S and
# dP, and the hand-off buffers between the warpgroups.
_FWD = "csrc/flash_attention.cu"
_BWDH = "csrc/flash_attention_bwd.cuh"
FA_LAYOUTS = (
    ("built: forward 32-key tiles, 2 stages, 1 TMA slot, S promoted every "
     "4 k-steps, O every 16 keys, P V in two halves of N = 64 (200 KB); "
     "backward 32-row tiles, 2 stages, S and dP promoted every 8 k-steps, 2 "
     "hand-off buffers (dq 209 KB, dK/dV 210 KB)", ()),
    ("forward: 16-key tiles, 3 stages, 2 TMA slots (160 KB)",
     ((_FWD, "static constexpr int BN = HDK <= 64 ? 64 : 32;",
       "static constexpr int BN = HDK <= 64 ? 64 : (HDK > 128 ? 16 : 32);"),
      (_FWD, "static constexpr int PS = HDK <= 32 ? 3 : 2;",
       "static constexpr int PS = HDK <= 32 || HDK > 128 ? 3 : 2;"),
      (_FWD, "static constexpr int RS = HDK > 128 ? 1 : 2;",
       "static constexpr int RS = 2;"))),
    ("forward: O promoted every 32 keys",
     ((_FWD, "static constexpr int OC = 2;",
       "static constexpr int OC = HDK > 128 ? 4 : 2;"),)),
    ("forward: S promoted every 2 k-steps",
     ((_FWD, "static constexpr int KC = HDK > 32 ? 4 : 1;",
       "static constexpr int KC = HDK > 128 ? 2 : (HDK > 32 ? 4 : 1);"),)),
    ("forward: P V in one product of N = 128",
     ((_FWD, "static constexpr int NH = HDV > 64 ? 2 : 1;",
       "static constexpr int NH = HDV > 64 && HDK <= 128 ? 2 : 1;"),)),
    ("forward: one consumer warpgroup (64 query rows a block)",
     ((_FWD, "static constexpr int W = 2;",
       "static constexpr int W = HDK > 128 ? 1 : 2;"),)),
    ("backward: dK/dV 16-query tiles (106 KB)",
     ((_BWDH, "static constexpr int BN = 32;",
       "static constexpr int BN = DKDV && HDK > 128 ? 16 : 32;"),
      ("ops.py", "128: (32, 2, 1, 2), 192: (32, 2, 1, 2)}}",
       "128: (32, 2, 1, 2), 192: (16, 2, 1, 2)}}"))),
    ("backward: S and dP promoted every 4 k-steps",
     ((_BWDH,
       "static constexpr int KC = HDK > 128 ? 8 : (HDK > 32 ? 4 : 1);",
       "static constexpr int KC = HDK > 32 ? 4 : 1;"),)),
    ("backward: one hand-off buffer (dq 185 KB, dK/dV 202 KB)",
     ((_BWDH, "static constexpr int NB = 2;",
       "static constexpr int NB = HDK > 128 ? 1 : 2;"),
      ("ops.py", "128: (32, 2, 1, 2), 192: (32, 2, 1, 2)},",
       "128: (32, 2, 1, 2), 192: (32, 2, 1, 1)},"),
      ("ops.py", "128: (32, 2, 1, 2), 192: (32, 2, 1, 2)}}",
       "128: (32, 2, 1, 2), 192: (32, 2, 1, 1)}}"))))


def edited_tree(root, edits):
    """A copy of src/ under ``root`` with each (file under
    kernels/flash_attention/, text, replacement) of ``edits`` made, each
    text found exactly once. Returns the copy's src/."""
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "src", root / "src")
    pkg = root / "src" / "repro_torch" / "kernels" / "flash_attention"
    for name, old, new in edits:
        text = (pkg / name).read_text()
        if text.count(old) != 1:
            raise AssertionError(f"{old!r} is not in {name} once")
        (pkg / name).write_text(text.replace(old, new))
    return str(root / "src")


def build_trees(trees):
    """flash_attention built in each src/ of ``trees``, all at once (one
    nvcc a source file each). Returns, for each, (its library's path, the
    ptxas report)."""
    outs = [Path(src).parent / "build" / "fa_build.json" for src in trees]
    t0 = time.perf_counter()
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys, json; "
         "sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import build; "
         "r = build.build(['flash_attention']); "
         "open(sys.argv[2], 'w').write(json.dumps("
         "[str(build._target('flash_attention')), "
         "r.get('flash_attention', '')]))", src, str(out)])
        for src, out in zip(trees, outs)]
    if any(p.wait(timeout=900) for p in builds):
        raise AssertionError("a build of flash_attention failed")
    log(f"{len(trees)} builds of flash_attention in "
        f"{time.perf_counter() - t0:.1f}s")
    return [tuple(json.loads(out.read_text())) for out in outs]


def fa_layouts(smi):
    """``--fa-layouts``: the forward and the backward at deepseek-v2's
    launch (FA_BWD_MLA's first case) under each layout of FA_LAYOUTS, each
    a copy of src/ under build/layouts/ with its lines rewritten, built
    together (one nvcc a source each), then timed in turns (the built one
    first and last), each turn its own process (``--fa-child SRC PATH
    mla``): each layout's two medians of each direction, the forward's
    largest difference from its plain version (limit 2e-5 relative and
    absolute) and the backward's from reference_backward (limit 1e-4 of
    the largest magnitude)."""
    trees = [edited_tree(ROOT / "build" / "layouts" / str(i), edits)
             for i, (_, edits) in enumerate(FA_LAYOUTS)]
    build_trees(trees)
    turns = list(range(len(trees))) + list(range(len(trees)))[::-1]
    runs = {i: [] for i in range(len(trees))}
    for n, i in enumerate(turns):
        path = ROOT / "build" / f"fa_layout_{n}.json"
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--fa-child", trees[i], str(path), "mla"],
                       check=True, timeout=900)
        runs[i].append(json.loads(path.read_text()))
        path.unlink()
    _, b, sq, _, h, _, hd, hd_v, *_ = FA_BWD_MLA[0]
    for i, (label, _) in enumerate(FA_LAYOUTS):
        f_err = max(r["fwd_err"] for r in runs[i])
        err = max(max(r["err"]) for r in runs[i])
        fwd, bwd = (" / ".join(f"{r['ms'][j]:.4f}" for r in runs[i])
                    for j in (0, 1))
        log(f"fa-layouts [{label}]: q and k ({b}, {sq}, {h}, {hd}), v ({b}, "
            f"{sq}, {h}, {hd_v}), causal: the forward {fwd} ms, the "
            f"backward {bwd} ms (CUDA events, median of {WINDOWS} means of "
            f"3 calls; turns {' '.join(map(str, turns))}); the forward's "
            f"largest difference from its plain version {f_err:.3e} (limit "
            f"2e-5 relative and absolute), the backward's from "
            f"reference_backward {err:.3e} of the largest magnitude (limit "
            f"1e-4); {smi}")
        if f_err > 2e-5 or err > 1e-4:
            raise AssertionError(f"fa-layouts [{label}]: the kernels differ "
                                 f"from their plain versions")
    return 0


# ---------------------------------------------------------------------------
# phase 20: the MLA score producer at full width
# ---------------------------------------------------------------------------

def mla_cache_bytes(cfg, batch, kv_len, n_attn):
    """(bytes of the MLA latent caches, bytes a GQA KV cache with K and V
    for every one of the same heads would take) at float32."""
    mla = 4 * batch * kv_len * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    gqa = 4 * batch * kv_len * cfg.n_heads * (
        cfg.qk_nope_head_dim + cfg.qk_rope_head_dim + cfg.v_head_dim)
    return n_attn * mla, n_attn * gqa


def mla_serve(smi):
    """Phase 20: deepseek-v2-236b at full width with its depth cut to its
    dense layer 0 and DS_MOE_LAYERS of its 59 identical MoE layers, random
    weights from a seeded torch.Generator on the card: the first batch
    teacher-forced through both routes with the routing compared
    (``moe_teacher_forced``: the kernel route's expanded prefill on
    flash_attention at head dims (192, 128), the plain route's on the
    grouped attention; decode the absorbed form on both), decode (absorbed,
    over the latent cache) against the forward (expanded, on the kernel)
    at the dropless capacity on GK_DECODE, one counted single-tenant serve
    run whose launches must be exact, the retained set against the top-K
    of the scores, the shares of token-choices dropped and each expert's
    demand at prefill, the latent caches' bytes beside a GQA KV cache's of
    the same heads, peak memory, then the profiles (the MoE's and the MLA
    attention's device spans and shares, the kernel's among them). Returns
    the launches."""
    from repro_torch import configs
    from repro_torch.configs.base import LayerSpec
    from repro_torch.kernels.entropy_scores import ops as ent
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import serve
    from repro_torch.models import ffn
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()  # the previous phases' blocks
    held = torch.cuda.memory_allocated() / 2**30
    full = configs.get_config(DS_ARCH)
    dense, moe = full.layers
    cfg = full.replace(layers=(dense, LayerSpec(count=DS_MOE_LAYERS,
                                                mixer=moe.mixer,
                                                ffn=moe.ffn)))
    run = DS_SERVE
    label = f"20 {DS_ARCH}"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    router = params["dec"][1][0]["ffn"]["router"]
    log(f"serve [{label}]: full width, depth cut to {cfg.n_layers} of "
        f"{full.n_layers} layers ({dense.count} dense, d_ff {cfg.d_ff}; "
        f"{DS_MOE_LAYERS} of {moe.count} MoE) (d_model {cfg.d_model}, MLA "
        f"with {cfg.n_heads} heads: kv_lora {cfg.kv_lora_rank}, q_lora "
        f"{cfg.q_lora_rank}, q/k head dim {cfg.qk_nope_head_dim} nope + "
        f"{cfg.qk_rope_head_dim} rope, v head dim {cfg.v_head_dim}; "
        f"{cfg.n_experts} routed experts of d_ff {cfg.d_ff_expert}, top-"
        f"{cfg.top_k_experts}, {cfg.n_shared_experts} shared, groups of "
        f"{cfg.moe_group_size}, capacity factor {cfg.capacity_factor}; "
        f"vocab {cfg.vocab_size}, tied embeddings {cfg.tie_embeddings}, "
        f"{cfg.param_dtype}): {lm.param_count(cfg)} parameters (the whole "
        f"model {lm.param_count(full)}) drawn on the card in "
        f"{time.perf_counter() - t0:.3f}s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB while drawn "
        f"({held:.3f} GiB held by earlier phases); router {router.dtype}; "
        f"TF32 off; {smi}")
    if router.dtype != torch.float32:
        raise AssertionError("the router is not float32")
    b, plen = run["batch"], run["prompt_len"]
    first = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, plen)), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    moe_teacher_forced(params, cfg, first, run["gen_len"])
    rows, p = GK_DECODE
    free = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k_experts)
    decode_vs_forward(params, free, first[:rows, :p].contiguous(),
                      f"{label}, dropless capacity factor "
                      f"{free.capacity_factor}")
    checks_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    # the counted run: counters to 0, serve, read
    fa.launches = ent.launches = 0
    with RouteLog() as routes:
        res = serve.serve(cfg, params, tenants=1, device="cuda", **run)
    launches = check_serve(res, cfg, run, f"{label}, single tenant", smi)
    order = np.lexsort((np.arange(run["requests"]), -res.scores))
    want = sorted(order[:run["topk"]].tolist())
    cap = ffn._capacity(cfg.moe_group_size, cfg.top_k_experts,
                        cfg.n_experts, cfg.capacity_factor)
    shares = dropped_shares(routes.calls, cap)
    demand, past = expert_demand(routes.calls, cap, DS_MOE_LAYERS,
                                 cfg.n_experts)
    dec_cap = ffn._capacity(b, cfg.top_k_experts, cfg.n_experts,
                            cfg.capacity_factor)
    kv_len = plen + run["gen_len"] + 1  # serve.generate's cache depth
    mla_b, gqa_b = mla_cache_bytes(cfg, b, kv_len, attention_layers(cfg))
    log(f"serve [{label}]: scores "
        f"{' '.join(f'{x:.7g}' for x in res.scores)}; retained "
        f"{res.retained}, top-{run['topk']} of the scores (ties to the "
        f"lower id) {want}; curation {res.curator.stats.as_dict()}; "
        f"token-choices dropped past capacity: prefill "
        f"{shares['prefill'][0]} of {shares['prefill'][1]} = "
        f"{shares['prefill'][0] / shares['prefill'][1]:.4f} ({cap} slots an "
        f"expert and group of {cfg.moe_group_size}), decode "
        f"{shares['decode'][0]} of {shares['decode'][1]} = "
        f"{shares['decode'][0] / shares['decode'][1]:.4f} ({dec_cap} slots "
        f"an expert for a step's {b} tokens); MLA latent caches of a batch "
        f"({b} x {kv_len} positions, {attention_layers(cfg)} layers, "
        f"float32) {mla_b} bytes, beside {gqa_b} bytes for a GQA KV cache "
        f"of K and V for all {cfg.n_heads} heads ({gqa_b / mla_b:.1f}x); "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB in the serve "
        f"run, {checks_peak:.3f} GiB in the checks before it (the plain "
        f"route's attention included); {smi}")
    log(f"serve [{label}] prefill demand: {demand}")
    del routes
    if past != shares["prefill"][0]:
        raise AssertionError(f"{past} choices past capacity, but "
                             f"{shares['prefill'][0]} dropped")
    if res.retained != want:
        raise AssertionError("retained set is not the top-K of the scores")
    serve_profile(params, cfg, first, smi)
    return launches


# ---------------------------------------------------------------------------
# phase 21: the encoder-decoder and the vision-patch frontend at full width
# ---------------------------------------------------------------------------

def model_generate(params, cfg, batch, gen, *, use_kernel=True, forced=None,
                   keep_logits=False):
    """``launch.serve.generate``'s loop through the model's own entry
    points, as the reference's tests/test_decode.py drives them, for a
    batch that may carry frames (encoder-decoder) or patch embeddings
    beside its tokens (with tokens alone, ``serve.generate`` itself):
    ``lm.prefill`` (the encoder, the cross-attention K/V
    written, or the patch prefix blended), then ``gen - 1`` greedy
    ``lm.decode_step``s, each step's logits scored by
    ``interestingness.entropy_score`` (the entropy_scores kernel unless
    ``use_kernel=False``); a request's score is the mean over the decode
    steps. ``forced`` teacher-forces the decode."""
    from types import SimpleNamespace
    from repro_torch.core import interestingness
    from repro_torch.models import lm
    prompts = batch["tokens"]
    b, s = prompts.shape
    t0 = time.perf_counter()
    cache = lm.init_cache(cfg, b, s + gen + 1, device=prompts.device,
                          enc_len=enc_len_of(batch))
    logits, cache = lm.prefill(params, cfg, batch, cache,
                               use_kernel=use_kernel)
    toks = [torch.argmax(logits, -1)]
    kept = [logits] if keep_logits else None
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ent_sum = torch.zeros((b,), dtype=torch.float32, device=prompts.device)
    for t in range(gen - 1):
        feed = toks[-1] if forced is None else forced[:, t]
        logits, cache = lm.decode_step(params, cfg, feed, cache)
        ent_sum += interestingness.entropy_score(logits[:, None],
                                                 use_kernel=use_kernel)
        toks.append(torch.argmax(logits, -1))
        if keep_logits:
            kept.append(logits)
    scores = ent_sum / (gen - 1)
    torch.cuda.synchronize()
    return SimpleNamespace(tokens=torch.stack(toks, 1), scores=scores,
                           prefill_s=t1 - t0,
                           decode_s=time.perf_counter() - t1, logits=kept)


def frontend_inputs(cfg, b, seed):
    """A batch's model inputs beside its tokens, float32 N(0, 1) from a
    seeded generator on the card (as data.synthetic draws them):
    whisper's WH_FRAMES frame embeddings or pixtral's n_patches patch
    embeddings."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.is_encoder_decoder:
        return {"frames": torch.randn((b, WH_FRAMES, cfg.d_model),
                                      device="cuda", generator=g)}
    return {"patch_embeds": torch.randn((b, cfg.n_patches, cfg.d_model),
                                        device="cuda", generator=g)}


def prefill_launches(cfg):
    """flash_attention launches of one prefill: one a decoder attention
    layer, one an encoder layer, one a cross-attention layer."""
    return (attention_layers(cfg)
            + sum(s.count for s in cfg.encoder_layers)
            + sum(s.count for s in cfg.layers if s.cross_attn))


def frontend_serve(smi, arch, sub, run):
    """Phase 21a/b: ``arch`` at full width and depth (``run["layers"]``,
    where given, cuts a single-group decoder's depth) with random weights
    from a seeded torch.Generator on the card, driven through the model's
    own entry points (``model_generate``): the first batch teacher-forced
    through both routes; decode against the forward; one counted run of
    every request whose launches must be exact (every prefill's
    attention on flash_attention, none at decode; entropy_scores at every
    scored step), finite scores of the right shape; prefill ms a batch
    (whisper: encode ms alone beside it), decode ms a step, tokens/s,
    peak memory, then the profiles. Returns (launches, flash_attention's
    launches by shape, params)."""
    from repro_torch import configs
    from repro_torch.kernels.entropy_scores import ops as ent
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()  # the previous phases' blocks
    held = torch.cuda.memory_allocated() / 2**30
    full = configs.get_config(arch)
    cfg = full
    if "layers" in run:
        cfg = full.replace(layers=(dataclasses.replace(
            full.layers[0], count=run["layers"]),))
    label = f"{sub} {arch}"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    enc = (f"encoder {sum(s.count for s in cfg.encoder_layers)} non-causal "
           f"layers over {WH_FRAMES} frame embeddings (sinusoidal positions), "
           f"decoder {cfg.n_layers - sum(s.count for s in cfg.encoder_layers)}"
           f" layers with cross-attention, learned positions of "
           f"{cfg.decoder_len}, LayerNorm, GELU, biases"
           if cfg.is_encoder_decoder else
           f"{cfg.n_layers} of {full.n_layers} layers, the first "
           f"{cfg.n_patches} positions "
           f"replaced by patch embeddings, RoPE theta {cfg.rope_theta:g}, "
           f"{cfg.ffn_act}")
    depth = "and depth" if cfg.n_layers == full.n_layers else "depth cut"
    log(f"serve [{label}]: full width, {depth} ({enc}; d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV heads "
        f"of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied "
        f"embeddings {cfg.tie_embeddings}, {cfg.param_dtype}): "
        f"{lm.param_count(cfg)} parameters drawn on the card in "
        f"{time.perf_counter() - t0:.3f}s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB while drawn "
        f"({held:.3f} GiB held by earlier phases); TF32 off; {smi}")
    b, plen = run["batch"], run["prompt_len"]
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (b, plen)), device="cuda"),
        **frontend_inputs(cfg, b, 21 + i)}
        for i in range(-(-run["requests"] // b))]
    first = batches[0]
    extra = {k: x for k, x in first.items() if k != "tokens"}
    torch.cuda.reset_peak_memory_stats()
    teacher_forced(params, cfg, first["tokens"], run["gen_len"], extra)
    decode_vs_forward(params, cfg, first["tokens"], label, extra=extra)
    checks_peak = torch.cuda.max_memory_allocated() / 2**30
    enc_text = ""
    if cfg.is_encoder_decoder:
        enc_ms = cuda_ms(lambda: lm.encode(params, cfg, first["frames"]), 3)
        enc_text = (f"; lm.encode alone {enc_ms:.3f} ms a batch of {b} x "
                    f"{WH_FRAMES} frames (CUDA events, mean of 3 calls)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the counted run: counters to 0, every batch, read
    fa.launches = ent.launches = 0
    fa.launches_at.clear()
    t0 = time.perf_counter()
    res = [model_generate(params, cfg, bt, run["gen_len"]) for bt in batches]
    seconds = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches,
                "entropy_scores": ent.launches}
    by_shape = dict(fa.launches_at)
    want = {"flash_attention": prefill_launches(cfg) * len(batches),
            "entropy_scores": (run["gen_len"] - 1) * len(batches)}
    log(f"serve [{label}] launches: {launches} (want {want}: per batch one "
        f"flash_attention a decoder self-attention, encoder and "
        f"cross-attention layer at prefill, none at decode; one "
        f"entropy_scores a scored decode step); flash_attention by shape "
        f"(B, Sq, Skv, H, KV, hd, causal): {by_shape}")
    if launches != want:
        raise AssertionError(f"serve [{label}] launches {launches} != {want}")
    scores = torch.cat([r.scores for r in res]).cpu().numpy()
    tokens = torch.cat([r.tokens for r in res]).cpu().numpy()
    n = run["requests"]
    if not (scores.shape == (n,) and np.isfinite(scores).all()
            and tokens.shape == (n, run["gen_len"])
            and ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"serve [{label}]: scores or tokens malformed")
    pre = [r.prefill_s * 1e3 for r in res]
    dec = [r.decode_s * 1e3 / (run["gen_len"] - 1) for r in res]
    top = sorted(np.lexsort((np.arange(n), -scores))[:run["topk"]].tolist())
    log(f"serve [{label}]: {n} requests in {seconds:.3f}s: prefill ms per "
        f"batch of {b} x {plen} median {statistics.median(pre):.3f} (min "
        f"{min(pre):.3f}, max {max(pre):.3f}){enc_text}; decode ms per token "
        f"step (batch {b}) median {statistics.median(dec):.3f} (min "
        f"{min(dec):.3f}, max {max(dec):.3f}); "
        f"{n * (plen + run['gen_len']) / seconds:.6g} tokens/s (prompt and "
        f"generated), {n * run['gen_len'] / seconds:.6g} generated tokens/s; "
        f"scores {' '.join(f'{x:.7g}' for x in scores)}; top-{run['topk']} "
        f"{top}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB in the counted "
        f"run, {checks_peak:.3f} GiB in the checks before it (the plain "
        f"route's attention included); host clock, device synced at each "
        f"phase end; {smi}")
    serve_profile(params, cfg, first["tokens"], smi, extra=extra)
    del batches, first, extra, res
    return launches, by_shape, params


def on_logit_path(path):
    """Whether a gradient leaf reaches the loss only through attention
    logits: the query and key projections of an attention (``wq``,
    ``bq``, ``wk``, ``bk``; MLA's low-rank query ``wq_a``, ``q_norm``,
    ``wq_b``) and the cross-attention's LayerNorm, which feeds its
    queries alone. Each row of the softmax's gradient dS sums to 0
    exactly, so these leaves are sums whose terms cancel (the key bias's
    exact gradient is 0), and whatever leaves a residue in a row's sum
    lands on them undiminished: they are the kernel route's most
    sensitive leaves, logged apart (held to the same rule). MLA's
    ``wkv_a``, ``kv_norm`` and ``wkv_b`` feed V too, so they are off this
    path."""
    return (path[-1] in ("wq", "bq", "wk", "bk", "wq_a", "q_norm", "wq_b")
            or "norm_cross" in path)


def square_sum(x):
    """Sum of the squares of ``x``'s elements in float64, a slice of 2^24
    at a time (no float64 copy of a large leaf)."""
    return sum(float(c.double().square().sum())
               for c in x.reshape(-1).split(1 << 24))


def grads_check(got, want, witness, label, frac=1e-4):
    """The kernel route's gradient tree ``got`` against the plain route's
    ``want`` on the card (the same paths; ``got`` may lie on the host,
    its leaves are moved to the card one at a time), and ``witness``, the
    CPU port's plain route on the same weights and batch, against
    ``want`` (None: no witness fits, and none is checked).
    Both routes are held alike: the whole within ``frac`` relative (L2)
    and each leaf within ``frac`` of its own largest magnitude (17a's
    rule), the key bias within ``frac`` of its value bias's (its exact
    gradient is 0). Logs the furthest leaves off and on the logits' path
    (``on_logit_path``) with the ratio of the kernel route's difference to
    the witness's, then raises past a limit. Returns (the whole's
    relative difference, the worst ratio to a leaf's limit scale off
    ("own") and on ("logit") the logits' path, the median kernel /
    witness ratio, nan without a witness)."""
    leaves = []

    def walk(a, w, c, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], w[k], None if c is None else c[k], path + (k,))
        elif isinstance(a, list):
            for i, x in enumerate(a):
                walk(x, w[i], None if c is None else c[i], path + (i,))
        else:
            leaves.append((path, a, w, c))

    walk(got, want, witness, ())
    tops = {path: float(w.abs().max()) for path, _, w, _ in leaves}
    nan = float("nan")
    rows, sums = [], [0.0, 0.0, 0.0]
    for path, a, w, c in leaves:
        own = max(tops[path], 1e-30)
        d = a.float().to(w.device) - w.float()
        ek = float(d.abs().max())
        sums[0] += square_sum(d)
        sums[2] += square_sum(w)
        del d
        ew = nan
        if c is not None:
            d = c.float().to(w.device) - w.float()
            ew = float(d.abs().max())
            sums[1] += square_sum(d)
            del d
        ref = tops[path[:-1] + ("bv",)] if path[-1] == "bk" else own
        rows.append({"path": path, "own": own, "ek": ek, "ew": ew,
                     "logit": on_logit_path(path),
                     "ratio": ek / max(ref, 1e-30),
                     "w_ratio": ew / max(ref, 1e-30),
                     "vs": ek / max(ew, 1e-30)})
    whole = (sums[0] / max(sums[2], 1e-300)) ** 0.5
    whole_w = (sums[1] / max(sums[2], 1e-300)) ** 0.5 if witness else nan
    vs = statistics.median(r["vs"] for r in rows)
    worst = {}
    for logit, name in ((False, "own"), (True, "logit")):
        part = sorted((r for r in rows if r["logit"] == logit),
                      key=lambda r: r["ratio"], reverse=True)
        worst[name] = part[0]["ratio"] if part else 0.0
        log(f"{label} gradients, {len(part)} leaves "
            f"{'on' if logit else 'off'} the logits' path, held to their own "
            f"largest magnitude (the key bias to its value bias's); the "
            f"furthest from the plain route, kernel difference / that "
            f"scale (its own largest; witness / that scale; kernel / "
            f"witness): "
            + "; ".join(
                f"{r['path']} {r['ratio']:.2e} ({r['own']:.2e}; "
                f"{r['w_ratio']:.2e}; {r['vs']:.3g})" for r in part[:6]))
    if witness is None:
        log(f"{label} gradients: the whole {whole:.3e} relative (L2) from the "
            f"plain route on the card; no witness (none fits beside the two "
            f"routes)")
    else:
        w_worst = max(r["w_ratio"] for r in rows)
        log(f"{label} gradients: the whole {whole:.3e} relative (L2) from "
            f"the plain route on the card, the witness (the CPU port's plain "
            f"route) {whole_w:.3e}, its leaves within {w_worst:.2e} of their "
            f"own largest magnitude (the key biases of their value biases'); "
            f"a leaf's kernel difference over the witness's median "
            f"{vs:.3g}, max {max(r['vs'] for r in rows):.4g} over "
            f"{len(rows)} leaves")
    bad = max(rows, key=lambda r: r["ratio"])
    if whole > frac or bad["ratio"] > frac:
        raise AssertionError(f"{label}: the gradients differ by {whole:.3e} "
                             f"relative, the leaf {bad['path']} by "
                             f"{bad['ratio']:.3e} of its own largest "
                             f"magnitude (a key bias: of its value "
                             f"bias's; limit {frac})")
    if witness is not None and w_worst > frac:
        raise AssertionError(f"{label}: the CPU port's plain route differs "
                             f"from the card's by {w_worst:.3e} of a leaf's "
                             f"largest magnitude (limit {frac})")
    return whole, worst, vs


def encdec_train(smi):
    """Phase 21a's training: whisper-base at full width, one StreamLoader
    batch of 8 examples (decoder_len tokens over WH_FRAMES frames)
    through ``steps.loss_and_grads`` on the kernel route (flash_attention
    and its backward in the encoder, the cross-attention and the decoder)
    and the plain route, and the CPU port's plain route as the witness:
    the loss and per-example NLL within 1e-5 relative, the gradients as
    ``grads_check`` holds them; one warm-up ``train_step``, then one
    timed with its peak memory; then WH_TRAIN_STEPS steps of
    ``runtime.train_loop.run``. Returns the counted launches, in all and
    by shape (``ops.launches_at`` / ``bwd_launches_at``)."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import StreamLoader
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.runtime import steps, train_loop
    cfg = configs.get_config(WH_ARCH)
    torch.cuda.empty_cache()
    state = steps.init_train_state(cfg, seed=0, reservoir_k=16,
                                   device="cuda")
    shape = ShapeConfig("21a", seq_len=WH_FRAMES, global_batch=8,
                        kind="train")
    loader = StreamLoader(cfg, shape, seed=0)
    batch = {k: torch.as_tensor(x, device="cuda")
             for k, x in loader.batch_for_step(0).items()}
    b, s = batch["tokens"].shape
    per = prefill_launches(cfg)
    # the counted run: counters to 0, the gradients, two steps, the loop
    fa.launches = fa.bwd_launches = 0
    fa.launches_at.clear()
    fa.bwd_launches_at.clear()
    loss_k, met_k, g_k = steps.loss_and_grads(state.params, cfg, batch)
    if (fa.launches, fa.bwd_launches) != (per, per):
        raise AssertionError(f"21a gradient launches {fa.launches}, "
                             f"{fa.bwd_launches} != {per} each")
    loss_p, met_p, g_p = steps.loss_and_grads(state.params, cfg, batch,
                                              use_kernel=False)
    t0 = time.perf_counter()
    host = {k: x.cpu() for k, x in batch.items()}
    _, met_c, g_c = steps.loss_and_grads(state_to(state.params, "cpu"), cfg,
                                         host, use_kernel=False)
    cpu_s = time.perf_counter() - t0
    rels = {}
    for key in ("loss", "per_example_nll"):
        a, w = met_k[key].double(), met_p[key].double()
        rels[key] = float(((a - w).abs() / w.abs()).max())
    rel_c = float(((met_c["loss"].double() - met_p["loss"].double().cpu())
                   .abs() / met_p["loss"].double().cpu().abs()).max())
    g_whole, g_worst, g_vs = grads_check(g_k, g_p, g_c, "train [21a]")
    log(f"train [21a {WH_ARCH} full width]: {b} x {s} tokens over "
        f"{batch['frames'].shape[1]} frames: kernel route vs plain route on "
        f"the card: loss {float(loss_k):.6f} / {float(loss_p):.6f}, "
        f"relative diffs loss {rels['loss']:.2e}, per-example NLL "
        f"{rels['per_example_nll']:.2e} (limit 1e-5; the CPU port's plain "
        f"route {rel_c:.2e}, in {cpu_s:.1f}s on the host); gradients "
        f"{g_whole:.2e} relative (L2), the leaves off the logits' path within "
        f"{g_worst['own']:.2e} of their own largest magnitude and those on "
        f"it within {g_worst['logit']:.2e} of theirs, the key bias of its "
        f"value bias's (limits 1e-4); the kernel "
        f"route a median {g_vs:.3g} times as far from the plain route as "
        f"the witness")
    if max(rels.values()) > 1e-5:
        raise AssertionError("21a: the kernel route's loss differs from the "
                             "plain route's")
    del g_k, g_p, g_c, host
    state, _ = steps.train_step(state, batch, cfg, lr=TR_LR)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, met = steps.train_step(state, batch, cfg, lr=TR_LR)
    loss = float(met["loss"])  # the step's one sync
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state, met
    rep = train_loop.run(cfg, loader, loop=train_loop.LoopConfig(
        total_steps=WH_TRAIN_STEPS, ckpt_every=10**6, lr=TR_LR),
        device="cuda")
    counted = {"flash_attention": fa.launches,
               "flash_attention_bwd": fa.bwd_launches}
    want = per * (3 + WH_TRAIN_STEPS)
    loop_ms = [x * 1e3 for x in rep.step_times]
    at = {name: (fa.launches_at[shp + (False,)],
                 fa.bwd_launches_at[shp + (False,)])
          for name, shp in (("encoder", FA_WH_ENC),
                            ("cross", FA_WH_CROSS_TRAIN))}
    at["decoder"] = (fa.launches_at[FA_WH_DEC_TRAIN + (True,)],
                     fa.bwd_launches_at[FA_WH_DEC_TRAIN + (True,)])
    log(f"train [21a] train_step of {b} x {s} tokens over {WH_FRAMES} "
        f"frames, after a warm-up step: {step_ms:.3f} ms (host clock, the "
        f"loss read syncs), loss {loss:.6f}, {b * s / step_ms * 1e3:.6g} "
        f"tokens/s, peak device memory {peak:.3f} GiB; train_loop.run, "
        f"{WH_TRAIN_STEPS} steps: losses "
        f"{' '.join(f'{x:.6f}' for x in rep.losses)}, step ms "
        f"{' '.join(f'{x:.3f}' for x in loop_ms)} (median after the first "
        f"{statistics.median(loop_ms[1:]):.3f}); launches {counted} (want "
        f"{want} each: one a flash_attention layer a gradient), by shape "
        f"(forward, backward) {at}; {smi}")
    if counted != {"flash_attention": want, "flash_attention_bwd": want}:
        raise AssertionError(f"21a training launches {counted} != {want}")
    n_each = want // 3
    if any(v != (n_each, n_each) for v in at.values()):
        raise AssertionError(f"21a training launches by shape {at} are not "
                             f"{n_each} each")
    if not (np.isfinite(rep.losses).all() and np.isfinite(loss)
            and rep.steps_run == WH_TRAIN_STEPS
            and np.mean(rep.losses[-2:]) < np.mean(rep.losses[:2])):
        raise AssertionError(f"21a: losses not finite or not falling: "
                             f"{rep.losses}")
    del rep
    torch.cuda.empty_cache()
    return counted, at


def encdec_frontends(smi):
    """Phase 21: whisper-base served (21a) and trained, then pixtral-12b
    served (21b), each at full width (21b cut in depth). Returns the
    launches of
    the kernels line's entries: in all, and those of each entry's shape
    (whisper's encoder and cross-attention, forward at serving and
    backward in training; pixtral's prefill)."""
    out = {}
    with phase_clock(f"{WH_ARCH} at full width (phase 21a)"):
        served, wh_at, params = frontend_serve(smi, WH_ARCH, "21a", WH_SERVE)
        del params
        trained, tr_at = encdec_train(smi)
    with phase_clock(f"{PX_ARCH} at full width (phase 21b)"):
        px, px_at, params = frontend_serve(smi, PX_ARCH, "21b", PX_SERVE)
        del params
        torch.cuda.empty_cache()
    out["flash_attention@whisper-encoder"] = wh_at.get(
        FA_WH_ENC + (False,), 0)
    out["flash_attention@whisper-cross"] = wh_at.get(
        FA_WH_CROSS + (False,), 0)
    out["flash_attention_bwd@whisper-encoder"] = tr_at["encoder"][1]
    out["flash_attention_bwd@whisper-cross"] = tr_at["cross"][1]
    out[f"flash_attention@{PX_ARCH}"] = px_at.get(
        (FA_PX[0], FA_PX[1], *FA_PX[1:], True), 0)
    out["flash_attention"] = (served["flash_attention"]
                              + trained["flash_attention"]
                              + px["flash_attention"])
    out["flash_attention_bwd"] = trained["flash_attention_bwd"]
    out["entropy_scores"] = (served["entropy_scores"]
                             + px["entropy_scores"])
    return out


# ---------------------------------------------------------------------------
# phase 22: training the soft-capped and the MLA models on the card;
# rematerialisation
# ---------------------------------------------------------------------------

TC_TRAIN = dict(batch=8, seq=1024, steps=8, reservoir_k=16)  # 22a
# 22c: the launcher on the reduced configs
TC_ARGV = ["--reduced", "--steps", "20", "--seq", "64", "--batch", "4",
           "--device", "cuda"]


def leaves_equal(a, b):
    """Whether two gradient trees are equal bit for bit, and the largest
    absolute difference of a leaf over that leaf's largest magnitude."""
    from repro_torch.optim.adamw import tree_leaves
    same, worst = True, 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if not torch.equal(x, y):
            same = False
            worst = max(worst, float((x - y).abs().max())
                        / max(float(y.abs().max()), 1e-30))
    return same, worst


def timed_grads(params, cfg, batch, **kw):
    """``steps.loss_and_grads`` on the card timed by the host clock, the
    device synced, with its peak memory: (loss, metrics, grads, ms, peak
    GiB)."""
    from repro_torch.runtime import steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, met, grads = steps.loss_and_grads(params, cfg, batch, **kw)
    torch.cuda.synchronize()
    return (loss, met, grads, (time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated() / 2**30)


def remat_check(params, cfg, batch, grads, label):
    """``cfg.remat`` against the run without it from the same weights and
    batch (``grads``, taken without remat): a second run without remat
    gives the spread of two such runs; the remat run's gradients must be
    bit-equal to ``grads`` where the two runs without it are, and
    otherwise within their spread. Returns (ms and peak GiB without, with
    remat)."""
    loss0, _, again, ms0, peak0 = timed_grads(params, cfg, batch)
    steady, spread = leaves_equal(again, grads)
    del again
    loss1, _, remat, ms1, peak1 = timed_grads(params, cfg.replace(remat=True),
                                              batch)
    same, diff = leaves_equal(remat, grads)
    del remat
    log(f"train [{label}] remat: loss_and_grads {ms1:.3f} ms, peak "
        f"{peak1:.3f} GiB with cfg.remat, {ms0:.3f} ms, peak {peak0:.3f} GiB "
        f"without (host clock, the device synced); losses "
        f"{float(loss1):.6f} / {float(loss0):.6f}; gradients bit-equal to "
        f"the run without remat: {same} (largest leaf difference {diff:.3e} "
        f"of its magnitude); two runs without remat bit-equal: {steady} "
        f"(spread {spread:.3e}); {torch.cuda.get_device_name(0)}")
    if not (same if steady else diff <= spread):
        raise AssertionError(f"{label}: the remat gradients differ by "
                             f"{diff:.3e}, beyond the spread {spread:.3e}")
    return (ms0, peak0), (ms1, peak1)


def deepseek_train(smi):
    """22a: deepseek-v2-236b at full width cut to layer 0 alone (MLA at
    head dims (192, 128) and its dense FFN; its AdamW state fits the
    card), TC_TRAIN's StreamLoader batches: the step-0 gradients on the
    kernel route against the plain route on the card (``grads_check``,
    no witness), remat beside no remat (``remat_check``), then the counted
    run of ``steps`` train_steps (losses finite and falling; one forward
    and one backward launch a step, at (192, 128)) and a profiled step.
    Returns the counted launches and those at the training shape."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import StreamLoader
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import lm
    from repro_torch.runtime import steps
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    full = configs.get_config(DS_ARCH)
    cfg = full.replace(layers=full.layers[:1])
    b, s, n = TC_TRAIN["batch"], TC_TRAIN["seq"], TC_TRAIN["steps"]
    t0 = time.perf_counter()
    state = steps.init_train_state(cfg, seed=0,
                                   reservoir_k=TC_TRAIN["reservoir_k"],
                                   device="cuda")
    torch.cuda.synchronize()
    log(f"train [22a {DS_ARCH} full width]: depth cut to layer 0 of "
        f"{full.n_layers} ({cfg.layers[0].mixer} + {cfg.layers[0].ffn} "
        f"FFN of d_ff {cfg.d_ff}; MLA with {cfg.n_heads} heads at q/k head "
        f"dim {cfg.qk_nope_head_dim + cfg.qk_rope_head_dim}, v head dim "
        f"{cfg.v_head_dim}; d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
        f"{cfg.param_dtype}): {lm.param_count(cfg)} parameters drawn on the "
        f"card with their AdamW moments in {time.perf_counter() - t0:.3f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated; {smi}")
    loader = StreamLoader(cfg, ShapeConfig("22a", seq_len=s, global_batch=b,
                                           kind="train"), seed=0)
    batches = [{k: torch.as_tensor(x, device="cuda")
                for k, x in loader.batch_for_step(i).items()}
               for i in range(n + 1)]
    loss_k, met_k, g_k, ms_k, _ = timed_grads(state.params, cfg, batches[0])
    loss_p, met_p, g_p, ms_p, _ = timed_grads(state.params, cfg, batches[0],
                                              use_kernel=False)
    rel = float(((met_k["per_example_nll"].double()
                  - met_p["per_example_nll"].double()).abs()
                 / met_p["per_example_nll"].double().abs()).max())
    g_whole, g_worst, _ = grads_check(g_k, g_p, None, "train [22a]")
    del g_p
    log(f"train [22a] step-0 gradients, {b} x {s} tokens: kernel route vs "
        f"plain route on the card: loss {float(loss_k):.6f} / "
        f"{float(loss_p):.6f}, per-example NLL within {rel:.2e} relative "
        f"(limit 1e-5); gradients {g_whole:.2e} relative (L2), the leaves "
        f"off the logits' path within {g_worst['own']:.2e} of their own "
        f"largest magnitude and those on it (MLA's query side) within "
        f"{g_worst['logit']:.2e} of theirs (limits 1e-4); no witness: "
        f"the port's model computes its norms, RoPE, attention logits and "
        f"router in float32 whatever the weights' type, so no float64 route "
        f"exists (the attention's own distance from float64 is phase 3's); "
        f"loss_and_grads {ms_k:.3f} ms on the kernel route, {ms_p:.3f} on "
        f"the plain route; {smi}")
    if rel > 1e-5:
        raise AssertionError("22a: the kernel route's NLL differs from the "
                             "plain route's")
    remat = remat_check(state.params, cfg, batches[0], g_k, "22a")
    del g_k
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the counted run: counters to 0, n steps, read
    fa.launches = fa.bwd_launches = 0
    fa.launches_at.clear()
    fa.bwd_launches_at.clear()
    losses, ms = [], []
    for i in range(n):
        t0 = time.perf_counter()
        state, met = steps.train_step(state, batches[i], cfg, lr=TR_LR)
        losses.append(float(met["loss"]))  # the step's one sync
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    shape = (b, s, s, cfg.n_heads, cfg.n_heads,
             cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, True)
    counted = {"flash_attention": fa.launches,
               "flash_attention_bwd": fa.bwd_launches,
               f"flash_attention_bwd@{DS_ARCH}": fa.bwd_launches_at[shape]}
    med = statistics.median(ms[1:])
    log(f"train [22a] {n} train_steps: losses "
        f"{' '.join(f'{x:.6f}' for x in losses)}; step ms "
        f"{' '.join(f'{x:.3f}' for x in ms)}; median after the first "
        f"{med:.3f} ms (min {min(ms[1:]):.3f}, max {max(ms[1:]):.3f}); "
        f"{b * s / med * 1e3:.6g} tokens/s; peak device memory {peak:.3f} "
        f"GiB (params, grads, moments and activations); launches {counted} "
        f"(want {n} each: one a step); remat's loss_and_grads "
        f"{remat[1][0]:.3f} ms, peak {remat[1][1]:.3f} GiB, beside "
        f"{remat[0][0]:.3f} ms, {remat[0][1]:.3f} GiB; host clock, the loss "
        f"read syncs; {smi}")
    if set(counted.values()) != {n}:
        raise AssertionError(f"22a launches {counted} != {n} each")
    if not all(np.isfinite(losses)) or \
            not np.mean(losses[-2:]) < np.mean(losses[:2]):
        raise AssertionError(f"22a: losses not finite or not falling: "
                             f"{losses}")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, met = steps.train_step(state, batches[n], cfg, lr=TR_LR)
        float(met["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = profile_report(prof, f"train [22a {DS_ARCH} step, {b} x {s}]", 1,
                          wall, smi)
    from torch.autograd import DeviceType
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    bwd = sum(e.time_range.end - e.time_range.start for e in dev
              if "flash_bwd" in e.name) / 1e3
    log(f"train [22a] flash_attention's backward in the profiled step: "
        f"{bwd:.3f} ms = {bwd / busy:.4f} of the device's busy {busy:.3f} "
        f"ms; {smi}")
    del state, met, batches, prof
    torch.cuda.empty_cache()
    return counted


def grok_grads(smi):
    """22b: grok-1-314b at full width cut to 1 of its 64 layers (soft-capped
    attention and the MoE; its AdamW state, 16 bytes a parameter, is
    larger than the card, so no train_step runs): loss_and_grads of a
    StreamLoader batch of TC_TRAIN's size, counted (one capped forward and
    backward launch) and timed, its peak memory; the gradients against
    the plain route's on the card (``grads_check``, no witness: a float64
    copy does not fit), the kernel route's moved to the host meanwhile.
    Returns the counted launches and those at the capped training
    shape."""
    from repro_torch import configs
    from repro_torch.configs.base import LayerSpec, ShapeConfig
    from repro_torch.data.pipeline import StreamLoader
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    full = configs.get_config(GK_ARCH)
    cfg = full.replace(layers=(LayerSpec(count=1, mixer="attn", ffn="moe"),))
    b, s = TC_TRAIN["batch"], TC_TRAIN["seq"]
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = lm.param_count(cfg)
    log(f"train [22b {GK_ARCH} full width]: depth cut to 1 of "
        f"{full.n_layers} identical attn + moe layers (attention logit "
        f"soft-cap {cfg.attn_logit_softcap}, {cfg.n_heads} heads over "
        f"{cfg.n_kv_heads} of {cfg.head_dim}, {cfg.n_experts} experts of "
        f"d_ff {cfg.d_ff_expert}, top-{cfg.top_k_experts}, capacity factor "
        f"{cfg.capacity_factor}): {n_params} parameters drawn on the card "
        f"in {time.perf_counter() - t0:.3f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB; no train_step: "
        f"AdamW's state of {16 * n_params / 2**30:.2f} GiB (parameters, "
        f"gradients, two moments) is larger than the card's "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} "
        f"GiB; {smi}")
    loader = StreamLoader(cfg, ShapeConfig("22b", seq_len=s, global_batch=b,
                                           kind="train"), seed=0)
    batch = {k: torch.as_tensor(x, device="cuda")
             for k, x in loader.batch_for_step(0).items()}
    fa.launches = fa.bwd_launches = 0
    fa.launches_at.clear()
    fa.bwd_launches_at.clear()
    loss_k, met_k, g_k, ms, peak = timed_grads(params, cfg, batch)
    shape = (b, s, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, True)
    counted = {"flash_attention": fa.launches,
               "flash_attention_bwd": fa.bwd_launches,
               f"flash_attention_bwd@{GK_ARCH}": fa.bwd_launches_at[shape]}
    if set(counted.values()) != {1}:
        raise AssertionError(f"22b launches {counted} != 1 each")
    t0 = time.perf_counter()
    # the kernel route's gradients into pinned host memory (fast copies
    # both ways)
    g_k = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                         pin_memory=True).copy_(x), g_k)
    host_s = time.perf_counter() - t0
    loss_p, met_p, g_p, ms_p, peak_p = timed_grads(params, cfg, batch,
                                                   use_kernel=False)
    rel = float(((met_k["per_example_nll"].double()
                  - met_p["per_example_nll"].double()).abs()
                 / met_p["per_example_nll"].double().abs()).max())
    g_whole, g_worst, _ = grads_check(g_k, g_p, None, "train [22b]")
    log(f"train [22b] loss_and_grads of {b} x {s} tokens: {ms:.3f} ms "
        f"(the first call at this shape, its set-up included), "
        f"{b * s / ms * 1e3:.6g} tokens/s, "
        f"peak device memory {peak:.3f} GiB (weights, gradients and "
        f"activations; host clock, the device synced); launches {counted}; "
        f"the plain route {ms_p:.3f} ms, peak {peak_p:.3f} GiB; kernel route "
        f"vs plain route: loss {float(loss_k):.6f} / {float(loss_p):.6f}, "
        f"per-example NLL within {rel:.2e} relative (limit 1e-5); gradients "
        f"{g_whole:.2e} relative (L2), the leaves off the logits' path within "
        f"{g_worst['own']:.2e} of their own largest magnitude and those on "
        f"it within {g_worst['logit']:.2e} of theirs (limits 1e-4); "
        f"no witness: a float64 copy of {n_params} parameters does not fit; "
        f"the kernel route's gradients held on the host ({host_s:.1f}s to "
        f"move); {smi}")
    if rel > 1e-5:
        raise AssertionError("22b: the kernel route's NLL differs from the "
                             "plain route's")
    del params, batch, g_k, g_p
    torch.cuda.empty_cache()
    return counted


def launcher_reduced(batch):
    """22c: ``python -m repro_torch.launch.train --arch A`` TC_ARGV on the
    reduced grok-1-314b and deepseek-v2-236b, children of the launcher
    batch (``batch``): exit code 0 and finite losses."""
    for arch in (GK_ARCH, DS_ARCH):
        run = batch[f"22c {arch}"]
        lines = run.out.strip().splitlines()
        losses = [float(x.split()[-1]) for x in lines
                  if x.strip().startswith("step ")]
        said = next((x for x in lines if x.startswith("done:")), "")
        log(f"train [22c] python -m repro_torch.launch.train --arch {arch} "
            f"{' '.join(TC_ARGV)}: exit {run.rc} after {run.wall:.1f}s (in "
            f"the launcher batch); {len(losses)} step losses logged; "
            f"{said.strip()}")
        if run.rc != 0 or not losses or not np.isfinite(losses).all():
            raise AssertionError(f"22c: the launcher failed on {arch}:\n"
                                 f"{run.out[-2000:]}\n{run.err[-4000:]}")


def llama_remat(smi):
    """22d: 17b's llama3.2-1b at full width, 8 x 1024 tokens: the
    gradients with cfg.remat against without (``remat_check``), then a
    train_step each way after a warm-up step, with its ms and peak
    memory."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import StreamLoader
    from repro_torch.runtime import steps
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    cfg = configs.get_config(ARCH)
    b, s = TR_FULL["batch"], TR_FULL["seq"]
    state = steps.init_train_state(cfg, seed=0,
                                   reservoir_k=TR_FULL["reservoir_k"],
                                   device="cuda")
    loader = StreamLoader(cfg, ShapeConfig("22d", seq_len=s, global_batch=b,
                                           kind="train"), seed=0)
    batch = {k: torch.as_tensor(x, device="cuda")
             for k, x in loader.batch_for_step(0).items()}
    grads = steps.loss_and_grads(state.params, cfg, batch)[2]
    remat_check(state.params, cfg, batch, grads, "22d")
    del grads
    out = {}
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        state, met = steps.train_step(state, batch, c, lr=TR_LR)  # warm-up
        float(met["loss"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, met = steps.train_step(state, batch, c, lr=TR_LR)
        float(met["loss"])
        out[remat] = ((time.perf_counter() - t0) * 1e3,
                      torch.cuda.max_memory_allocated() / 2**30)
    log(f"train [22d {ARCH} full width, {b} x {s}] train_step after a "
        f"warm-up: {out[True][0]:.3f} ms, peak {out[True][1]:.3f} GiB with "
        f"cfg.remat; {out[False][0]:.3f} ms, peak {out[False][1]:.3f} GiB "
        f"without; host clock, the loss read syncs; {smi}")
    del state, met, batch
    torch.cuda.empty_cache()


def capped_mla_training(smi, batch):
    """Phase 22: 22a deepseek-v2-236b trained at full width (layer 0), 22b
    grok-1-314b's gradients at full width (1 layer), 22c the launcher on
    both reduced configs (from ``batch``), 22d remat at llama3.2-1b's
    full width. Returns the launches of 22a and 22b for the kernels
    line."""
    from torch.utils.checkpoint import checkpoint
    # torch.utils.checkpoint sets itself up at its first call (seconds of
    # imports): paid here, before any remat run is timed
    t0 = time.perf_counter()
    x = torch.ones(1, device="cuda", requires_grad=True)
    checkpoint(torch.sin, x, use_reentrant=False).sum().backward()
    log(f"train [22] the first torch.utils.checkpoint call, set-up "
        f"included: {time.perf_counter() - t0:.3f}s")
    out = {}
    for part in (deepseek_train(smi), grok_grads(smi)):
        for key, n in part.items():
            out[key] = out.get(key, 0) + n
    launcher_reduced(batch)
    llama_remat(smi)
    return out


# ---------------------------------------------------------------------------
# phase 23: the model-side mesh and the dry run
# ---------------------------------------------------------------------------

# 23a's archs: dense, MLA and MoE (the ten take ~40 s of host time; the
# rest are the CLI's: python -m repro_torch.launch.dryrun --all)
DRY_ARCHS = ("llama3.2-1b", "deepseek-v2-236b", "grok-1-314b")
PSUM_N, PSUM_ROUNDS, PSUM_SHARDS = 4_194_304, 64, 2  # 23c


def dry_run_records(smi):
    """23a: dryrun.run_cell at train_4k x single for DRY_ARCHS, on the
    host; a line a record."""
    from repro_torch.launch import dryrun
    recs = {}
    t0 = time.perf_counter()
    for arch in DRY_ARCHS:
        rec = dryrun.run_cell(arch, "train_4k", "single", verbose=False)
        if rec["status"] != "ok":
            raise AssertionError(f"dry run [23a {arch}]: {rec}")
        roof = rec["roofline"]
        log(f"dry run [23a {arch} x train_4k x single] {rec['status']}: "
            f"{rec['n_chips']} chips, per chip argument bytes "
            f"{rec['memory']['argument_bytes']}, temp bytes "
            f"{rec['memory']['temp_bytes']}, flops "
            f"{roof['flops_per_chip']:.6e}, HBM bytes "
            f"{roof['hbm_bytes_per_chip']:.6e}, link-bytes "
            f"{roof['collective_link_bytes_per_chip']:.6e}, t_compute "
            f"{roof['t_compute_s']:.6g} s, t_memory {roof['t_memory_s']:.6g}"
            f" s, t_collective {roof['t_collective_s']:.6g} s -> "
            f"{roof['bottleneck']}; useful flops "
            f"{rec['useful_flops_ratio']:.4f}; traced in {rec['trace_s']} s "
            f"(host; bounds at the H100 SXM's published peaks; {smi})")
        recs[arch] = rec
    log(f"dry run [23a] {len(DRY_ARCHS)} cells in "
        f"{time.perf_counter() - t0:.1f}s of host time; {smi}")
    return recs


def dry_run_slice(smi, rec):
    """23b: the per-chip slice of llama3.2-1b's train_4k on the card
    (inspect_cell.card_slice), held to the dry run's record ``rec``.
    Returns its flash_attention launches."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import dryrun, inspect_cell
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.ctx import LogicalMesh
    torch.cuda.empty_cache()
    shape = configs.get_shape("train_4k")
    cfg = dryrun.cell_config(ARCH, shape, "single")
    sl, scale = inspect_cell.slice_shape(shape, rec["n_chips"])
    fa.launches = fa.bwd_launches = 0
    fa.launches_at.clear()
    fa.bwd_launches_at.clear()
    res = inspect_cell.card_slice(ARCH, "train_4k", "single", warm=2,
                                  timed=5, top=5)
    launches = {"flash_attention": fa.launches,
                "flash_attention_bwd": fa.bwd_launches}
    # every launch at the shape phase 3 holds to the plain version
    at = (*FA_SLICE[:2], *FA_SLICE[1:], True)
    shapes = set(fa.launches_at) | set(fa.bwd_launches_at)
    if shapes != {at}:
        raise AssertionError(f"dry run [23b] flash_attention launched at "
                             f"{sorted(shapes)}, not only at phase 3's "
                             f"slice case {at}")
    b, seq, h, kvh, hd = FA_SLICE
    plan = fa.backward_plan(b, h, kvh, seq, seq, hd)
    log(f"dry run [23b] flash_attention launched {launches} times, all at "
        f"B={b} Sq=Skv={seq} H={h} KV={kvh} hd={hd} causal (phase 3's "
        f"slice case; the backward split {plan['split']}); {smi}")
    n_steps = 2 + 5 + 1 + 1  # warm, timed, profiled, counted
    layers = cfg.n_layers
    want = {"flash_attention": 2 * layers * n_steps,  # forward + remat's
            "flash_attention_bwd": layers * n_steps}
    if launches != want:
        raise AssertionError(f"dry run [23b] launches {launches} != {want}")
    roof = rec["roofline"]
    count = res["count"]
    ratio = count["flops"] * scale / roof["detail"]["global_flops"]
    bytes_ratio = count["bytes"] * scale / roof["detail"]["global_bytes"]
    med = res["median_ms"]
    log(f"dry run [23b {ARCH} slice {sl.global_batch} x {sl.seq_len}, "
        f"1/{scale:g} of train_4k, bfloat16, remat] train_step "
        f"{med:.3f} ms median of {len(res['ms'])} (CUDA events; "
        f"{', '.join(f'{t:.3f}' for t in res['ms'])}); roofline per chip "
        f"for the same tokens: t_compute {roof['t_compute_s'] * 1e3:.3f} ms"
        f" (share {roof['t_compute_s'] * 1e3 / med:.4f}), t_memory "
        f"{roof['t_memory_s'] * 1e3:.3f} ms (share "
        f"{roof['t_memory_s'] * 1e3 / med:.4f}); {smi}")
    log(f"dry run [23b] op_count of the card step: flops "
        f"{count['flops']:.6e} x {scale:g} = {count['flops'] * scale:.6e} "
        f"beside the dry run's {roof['detail']['global_flops']:.6e} "
        f"(ratio {ratio:.6f}, held within 1%: the meta route and the card "
        f"route count alike — not a check that the count is right, which "
        f"tests/test_torch_dryrun.py::"
        f"test_reduced_cells_against_the_reference_dry_run makes against "
        f"hlo_parse); bytes "
        f"{count['bytes']:.6e} x {scale:g} beside "
        f"{roof['detail']['global_bytes']:.6e} (ratio {bytes_ratio:.4f}, "
        f"not held: the weights' and the optimizer's bytes do not scale "
        f"with the batch); {count['operations']} operations; {smi}")
    if abs(ratio - 1.0) > 0.01:
        raise AssertionError(f"dry run [23b] card flops x {scale:g} off "
                             f"the dry run's by {ratio:.6f}")
    # the slice's own trace on meta: its peak live bytes above its
    # arguments (the state and the batch), beside the card's peak
    oc, _, _ = dryrun.trace(cfg.replace(seq_parallel=False), sl)
    one = LogicalMesh((1, 1), ("data", "model"))
    _, args, in_sp, _ = dryrun.build_cell(cfg, sl, one)
    traced = oc.peak_bytes + shd.local_bytes(one, args, in_sp)
    if oc.flops != count["flops"]:
        raise AssertionError(f"dry run [23b] the card step's flops "
                             f"{count['flops']} != the meta trace's "
                             f"{oc.flops}")
    log(f"dry run [23b] peak memory {res['peak_bytes'] / 2**30:.3f} GiB "
        f"(max_memory_allocated over the timed steps) beside the slice's "
        f"traced {traced / 2**30:.3f} GiB (peak live "
        f"{oc.peak_bytes / 2**30:.3f} + arguments "
        f"{(traced - oc.peak_bytes) / 2**30:.3f}): ratio "
        f"{res['peak_bytes'] / traced:.4f}; the meta trace's flops equal "
        f"the card step's; {smi}")
    for name, dev_ms, calls in res["top_kernels"]:
        log(f"dry run [23b] top kernel {dev_ms:9.4f} ms in {calls} calls "
            f"(one profiled step; {smi})  {name[:90]}")
    return launches


def dry_run_psum(smi):
    """23c: compressed_psum over PSUM_SHARDS shards on cuda:0 against the
    CPU port, PSUM_ROUNDS rounds of error feedback, bit for bit."""
    from repro_torch.parallel import collectives as coll
    rng = np.random.default_rng(23)
    # each round's gradient: a seeded base per shard at a round's scale
    base = rng.standard_normal((PSUM_SHARDS, PSUM_N), dtype=np.float32)
    scales = 10.0 ** rng.uniform(-3, 1, (PSUM_ROUNDS, PSUM_SHARDS))
    out = {}
    for dev in ("cuda:0", "cpu"):
        errs = None
        t0 = time.perf_counter()
        means = []
        shards = torch.from_numpy(base).to(dev)
        for r in range(PSUM_ROUNDS):
            m, errs = coll.compressed_psum(
                [shards[i] * float(scales[r, i])
                 for i in range(PSUM_SHARDS)], errs)
            means.append(m[0].cpu())
        if dev != "cpu":
            torch.cuda.synchronize()
        out[dev] = (means, [e.cpu() for e in errs],
                    time.perf_counter() - t0)
    for r, (a, b) in enumerate(zip(out["cuda:0"][0], out["cpu"][0])):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"dry run [23c] round {r}: the card's mean "
                                 f"differs from the CPU's")
    for a, b in zip(out["cuda:0"][1], out["cpu"][1]):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError("dry run [23c] the card's residual "
                                 "differs from the CPU's")
    log(f"dry run [23c] compressed_psum, {PSUM_SHARDS} shards on cuda:0, "
        f"{PSUM_ROUNDS} rounds of error feedback on ({PSUM_N},) float32: "
        f"means and residuals bit-equal to the CPU port's; payload "
        f"{PSUM_N + 4} bytes a shard (int8 and its float32 scale) beside "
        f"{4 * PSUM_N} float32; {out['cuda:0'][2]:.3f} s on the card "
        f"(host clock, a host copy a round), {out['cpu'][2]:.3f} s on the "
        f"CPU; {smi}")


def dry_run(smi):
    """Phase 23: 23a the dry-run records, 23b the per-chip slice on the
    card, 23c compressed_psum on the card. Returns 23b's launches."""
    recs = dry_run_records(smi)
    launches = dry_run_slice(smi, recs[ARCH])
    dry_run_psum(smi)
    return launches


# ---------------------------------------------------------------------------
# phase 24: the example scripts on the card
# ---------------------------------------------------------------------------

EXAMPLES_OUT = ROOT / "build" / "examples24"
# each script of examples_torch/ but multi_tenant_streams (phase 6 runs
# it) with its argv, at its defaults but for million_streams' CI scale
# and the outputs put under build/, and the kernels it must launch (none
# for the two host scripts, which must launch none)
EXAMPLE_RUNS = (
    ("million_streams", ["--ci", "--devices", str(SHARDS), "--out",
                         str(EXAMPLES_OUT / "million_streams.json")],
     ("plan_solve", "batched_topk", "logmem_update")),
    ("online_replanning", [], ("batched_topk",)),
    ("fleet_telemetry", ["--out", str(EXAMPLES_OUT / "obs_out")],
     ("batched_topk",)),
    ("cost_attribution", [], ("batched_topk",)),
    ("chaos_recovery", ["--ckpt-dir", str(EXAMPLES_OUT / "chaos_ckpt"),
                        "--out", str(EXAMPLES_OUT / "chaos_out")],
     ("batched_topk",)),
    ("serve_topk", ["--tenants", "4"], ("flash_attention", "entropy_scores")),
    ("quickstart", [], ("flash_attention", "flash_attention_bwd")),
    ("three_tier_cloud", [], ()),
    ("capacity_slo_cloud", [], ()))
# what phase 24 holds of a script's result where the script has no gate
# of its own
EXAMPLE_CHECKS = {
    "serve_topk": ("every tenant retains its top-K", lambda res: all(
        len(res.res.retained[t]) == spec.k
        for t, spec in enumerate(res.res.specs))),
    "quickstart": ("device reservoir == host curator", lambda res: res.same)}


def kernel_counters():
    """{kernel: (ops module, its counter's name)} for every kernel."""
    from repro_torch.kernels.batched_topk import ops as btk
    from repro_torch.kernels.entropy_scores import ops as ent
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.logmem_update import ops as lm_ops
    from repro_torch.kernels.plan_solve import ops as ps
    from repro_torch.kernels.tier_assign import ops as ta
    from repro_torch.kernels.topk_filter import ops as tf
    return {"batched_topk": (btk, "launches"),
            "tier_assign": (ta, "launches"),
            "logmem_update": (lm_ops, "launches"),
            "topk_filter": (tf, "launches"),
            "plan_solve": (ps, "launches"),
            "entropy_scores": (ent, "launches"),
            "flash_attention": (fa, "launches"),
            "flash_attention_bwd": (fa, "bwd_launches")}


def example_scripts():
    """Phase 24: each script's run(parse_args(argv)) in this process
    (chaos_recovery starts its child as a subprocess, as the script
    does), its printed lines logged, its wall seconds and its launches of
    every kernel (the counters set to 0 just before it and read just
    after). A script that fails ends the run. Returns the launches summed
    over the scripts."""
    import contextlib
    import io
    import shutil
    counters = kernel_counters()
    total = dict.fromkeys(counters, 0)
    shutil.rmtree(EXAMPLES_OUT, ignore_errors=True)
    EXAMPLES_OUT.mkdir(parents=True)
    walls = {}
    for name, argv, kernels in EXAMPLE_RUNS:
        script = example(name)
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = script.run(script.parse_args(argv))
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        counts = {key: getattr(mod, attr)
                  for key, (mod, attr) in counters.items()}
        lines = buf.getvalue().splitlines()
        for line in lines:
            log(f"examples [24 {name}] | {line}")
        launched = {key: n for key, n in counts.items() if n}
        log(f"examples [24 {name}]: exit 0, {walls[name]:.3f}s wall, last "
            f"line {lines[-1]!r}, launches {launched}")
        if name in EXAMPLE_CHECKS:
            what, check = EXAMPLE_CHECKS[name]
            log(f"examples [24 {name}]: {what}: {bool(check(res))}")
            if not check(res):
                raise AssertionError(f"{name}: not {what}")
        missed = [key for key in kernels if not counts[key]]
        if missed or (not kernels and launched):
            raise AssertionError(f"{name}: expected launches of "
                                 f"{list(kernels)}, got {launched}")
        for key, n in counts.items():
            total[key] += n
    log(f"examples [24]: {len(walls)} scripts in {sum(walls.values()):.3f}s "
        f"wall (limit 90 s by the phase clock), launches {total}")
    shutil.rmtree(EXAMPLES_OUT, ignore_errors=True)
    return total


def main():
    t_main = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # cuBLAS is deterministic under torch.use_deterministic_algorithms
    # (phase 17c's resume check) only with a fixed workspace, set before
    # its first call; 8 x 4 MiB is the size PyTorch gives Hopper anyway
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:2] == ["--chaos-child"]:
        return chaos_child(sys.argv[2])  # phase 15b's child process
    if sys.argv[1:2] == ["--fa-child"]:
        return fa_child(*sys.argv[2:5])  # a turn of --fa-ab / --fa-layouts
    smi = environment()
    if sys.argv[1:2] == ["--fa-ab"]:
        return fa_ab(sys.argv[2], smi)
    if sys.argv[1:2] == ["--fa-layouts"]:
        return fa_layouts(smi)
    with phase_clock("build and log2 rule (phase 2)"):
        sass = build_kernels()
        log2_rule()
    with phase_clock("parity (phase 3) beside the launcher batch (the "
                     "launchers of 15c, 16c, 17d and 22c)"):
        launchers = LauncherBatch()
        launchers.start()
        try:
            errs, solves = kernel_parity()
            errs.update(score_kernel_parity())
            errs.update(flash_backward_parity())
        except BaseException:
            launchers.kill()
            if sass is not None:
                sass.kill()
            raise
        batch, saved = launchers.wait()
        if sass is not None:
            sass.check()
    with phase_clock("timings (phase 4)"):
        times = kernel_timings()
        times["plan_solve"] = plan_solve_timings(solves)
        del solves
        times.update(score_kernel_timings(smi))
        times.update(flash_backward_timings(smi))
    with phase_clock("main path, self-check, step profile (phases 5-7)"):
        eng, launches, rng, (bounds, mig, rate5, plan5) = main_path()
        self_check()
        step_profile(eng, window_chunks(rng, 1 + TIMED_WINDOWS, 4),
                     f"{M} x {CHUNK}")
        del eng
    with phase_clock("mixed fleet, huge-K harness, single stream "
                     "(phases 8-10)"):
        launches["logmem_update"] = mixed_fleet(bounds, mig,
                                                rate5)["logmem_update"]
        huge_k_harness()
        launches["topk_filter"] = single_stream()
    with phase_clock("score producer (phase 11)"):
        launches.update(score_producer(smi))
    with phase_clock(f"{SC_ARCH} at full width (phase 12)"):
        for key, n in dense_serve(smi, SC_ARCH, SC_SERVE).items():
            launches[key] += n
    with phase_clock("drift-aware re-planning at fleet scale (phase 13)"):
        for key, n in replanning(smi).items():
            launches[key] += n
    with phase_clock("fleet observability (phase 14)"):
        for key, n in observability(bounds, mig, rate5, smi).items():
            launches[key] += n
    with phase_clock("crash recovery, chaos drill, graceful drain "
                     "(phase 15)"):
        for key, n in resilience(bounds, mig, batch).items():
            launches[key] += n
    with phase_clock(f"fleet-axis sharding, {SHARDS} shards on the card "
                     "(phase 16)"):
        for key, n in sharded(bounds, mig, plan5, batch).items():
            launches[key] += n
        del plan5
    with phase_clock("training with top-K curation (phase 17)"):
        launches["flash_attention_bwd"] = 0
        for key, n in training(smi, batch).items():
            launches[key] += n
    with phase_clock("ssm and hybrid score producers (phase 18)"):
        for key, n in ssm_hybrid(smi).items():
            launches[key] += n
    with phase_clock(f"{GK_ARCH} at full width, {GK_LAYERS} layers "
                     "(phase 19)"):
        for key, n in moe_serve(smi).items():
            launches[key] += n
    with phase_clock(f"{DS_ARCH} at full width, {1 + DS_MOE_LAYERS} layers "
                     "(phase 20)"):
        ds = mla_serve(smi)
        launches["flash_attention@deepseek"] = ds["flash_attention"]
        for key, n in ds.items():
            launches[key] += n
    with phase_clock("encoder-decoder and vision frontend at full width "
                     "(phase 21)"):
        for key, n in encdec_frontends(smi).items():
            launches[key] = launches.get(key, 0) + n
    with phase_clock("training the soft-capped and the MLA models; remat "
                     "(phase 22)"):
        for key, n in capped_mla_training(smi, batch).items():
            launches[key] = launches.get(key, 0) + n
    with phase_clock("the model-side mesh and the dry run (phase 23)"):
        for key, n in dry_run(smi).items():
            launches[key] += n
    with phase_clock("the example scripts on the card (phase 24)"):
        for key, n in example_scripts().items():
            launches[key] += n
    with phase_clock(f"{YI_ARCH} and {CR_ARCH} at full width "
                     "(phase 25)") as p25:
        for key, n in dense_full(smi).items():
            launches[key] = launches.get(key, 0) + n
    log(f"phase clock: the launcher batch ran {saved:.1f}s shorter than its "
        f"launchers' own walls added up; phase 25 took {p25.seconds:.1f}s")
    replaces = {
        "batched_topk": "src/repro/kernels/batched_topk/batched_topk.py:32",
        "tier_assign": "src/repro/kernels/tier_assign/tier_assign.py:47",
        "logmem_update":
            "src/repro/kernels/logmem_update/logmem_update.py:40",
        "topk_filter": "src/repro/kernels/topk_filter/topk_filter.py:33",
        "plan_solve": "src/repro/kernels/plan_solve/plan_solve.py:81",
        "entropy_scores":
            "src/repro/kernels/entropy_scores/entropy_scores.py:56",
        "flash_attention":
            "src/repro/kernels/flash_attention/flash_attention.py:64",
        # the same kernel at MLA's unequal head dims, deepseek-v2's shape
        "flash_attention@deepseek":
            "src/repro/kernels/flash_attention/flash_attention.py:64",
        # no Pallas backward exists: the counterpart of XLA's derivative of
        # the reference's training attention (grouped_attention)
        "flash_attention_bwd": "src/repro/models/attention.py:113",
        # the same kernels at phase 21's launches, each entry's launches
        # those of its shape: whisper-base's encoder self-attention and
        # its cross-attention (non-causal; the forward at serving, the
        # backward at training) and pixtral-12b's prefill
        "flash_attention@whisper-encoder":
            "src/repro/kernels/flash_attention/flash_attention.py:64",
        "flash_attention@whisper-cross":
            "src/repro/kernels/flash_attention/flash_attention.py:64",
        "flash_attention_bwd@whisper-encoder":
            "src/repro/models/attention.py:113",
        "flash_attention_bwd@whisper-cross":
            "src/repro/models/attention.py:113",
        f"flash_attention@{PX_ARCH}":
            "src/repro/kernels/flash_attention/flash_attention.py:64",
        # phase 25's prefills: yi-9b's group of 8, command-r-plus-104b's
        # 96 query heads over 8
        f"flash_attention@{YI_ARCH}":
            "src/repro/kernels/flash_attention/flash_attention.py:64",
        f"flash_attention@{CR_ARCH}":
            "src/repro/kernels/flash_attention/flash_attention.py:64",
        # the backward at phase 22's full-width launches, each entry's
        # launches those of its shape: grok-1-314b's soft-capped and
        # deepseek-v2-236b's at MLA's head dims (192, 128)
        f"flash_attention_bwd@{GK_ARCH}": "src/repro/models/attention.py:113",
        f"flash_attention_bwd@{DS_ARCH}":
            "src/repro/models/attention.py:113"}
    kernels = []
    for name in replaces:
        t = times[name]
        base = name.split("@")[0]  # flash_attention_bwd: the backward's .cu
        src = base.removesuffix("_bwd")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{src}/csrc/{base}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    log(f"phase clock: the whole run took "
        f"{time.perf_counter() - t_main:.1f}s (limit 1200 s)")
    log(f"card: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
