#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit:

1. The card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel (one ``nvcc`` per source, all started together), and
   the count of ``HGMMA`` (wgmma) instructions in each library's SASS
   (``cuobjdump -sass``, in the background during phase 2, gated at its
   end): flash attention and tp_matmul must have some.
2. Kernel phase: each attention kernel against its plain PyTorch version on
   the card, in the working dtype, at the serving path's shapes (head_dim 256, GQA
   group 2, pages of 64 and 16 tokens; bf16 and fp8-e5m2 pools; ragged
   ``kv_len`` with an idle row; window, softcap, aliased pages; a prefill
   chunk at ``q_offset > 0``; one stream at 8191 keys; 16 slots; the
   generate phase's ragged prefill chunk and last decode step; the MLA
   phase's prefill read, V's head dim 64 against QK's 96, ragged and
   uniform; the speculative phase's verify fold ``decode_bf16_p64_verify``:
   4 slots x 4 positions folded into 128 rows, read at the step form's
   partition (the size ``kernels.ops`` picks for the 4 slots), BITWISE
   the 4 step-form calls, timed also at the fold's own partition, as the 4 step calls and as SDPA without
   softcap; the MoE phases' reads: qwen3-moe's decode at group 8, head
   dim 128 on a bf16 and an fp8-e5m2 pool (``decode_bf16_p64_qwen3``,
   ``decode_fp8_p64_qwen3``), its 256-token chunk
   (``flash_bf16_p64_qwen3_chunk``), and deepseek-v2-lite's expanded
   prefill on ``flash_tc`` at QK head dim 192, V 128
   (``flash_mla_bf16_192``, ``flash_fma`` timed beside it); the granite
   phase's reads at group 48, head dim 128: decode on a bf16, an
   fp8-e5m2 and an f32 pool (``decode_bf16_p64_granite`` on ``mma``,
   ``decode_fp8_p64_granite``, ``decode_f32_p64_granite`` on ``fma``) and
   its 256-token chunk on ``flash_tc`` (``flash_bf16_p64_granite_chunk``);
   the last attention archs' reads
   (``arch_kernel_cases``): gemma3's windowed decode and chunk at group 2
   without softcap, internvl2's decode and 1024-query prefill at group 6,
   whisper's non-causal encoder read (4 x 12 heads x 1500 x 1500 at D
   64) and cross prefill, its decode over the contiguous 1500-frame cross
   cache and its self cache at group 1; zamba2's shared attention
   block at group 1, D 64: decode over 4 contiguous rows of 1031 keys
   and the 4 x 32 heads x 1000-query causal prefill; none has a softcap,
   so SDPA computes each), the plain flash version walking the kernel's
   own key tiles.
   One JSON line
   per case: error and tolerance, the variant (and for decode the cluster
   size, for ``flash_tc`` the query tile, and for tp_matmul the plan its
   launch counted, which must be the one ``kernels.ops`` picks: a winner
   of the autotuner for this card and build, else the static rule) that
   ran, kernel / plain / library time, and the card's least time for
   the same work (``bound_ms``).  Kernel and library times are device
   times per call from a replayed CUDA graph (``device_ms``); ``eager_ms``
   is the same call launched from Python, host overhead included;
   ``plain_ms`` is eager; decode's ``kernel_only_ms`` times the kernel's
   own launch without the wrapper's index expansion.  The main flash cases
   and every split-route case also time the kept FMA variant
   (``fma_ms``) and hold its output against the plain version at its own
   tiles (``fma_max_abs_err``); the split route's ``bound_ms`` counts each
   kept piece pair as one pass at the bf16 rate (``split_passes``).
   Every case also runs the kernel's telemetry instantiation
   (``debug_visits`` / ``debug_flags``): its output must be bitwise the
   flags-off output, its visits and flag counts exactly the plain
   version's, on the route named (``flags_ms``).  The f32-pool cases
   ``decode_f32_p64_local`` (route fma) and ``flash_f32_p64_chunk`` (the
   split route) hold the escalation phase's routes at the slice's shapes
   within ``F32_TOL``; ``flash_f32_contig_nocap`` times SDPA in f32 beside
   the split route, and ``flash_f32_fp32_small`` holds it at D 128 with
   pages of 16; ``flash_f32_p64_wide_table`` runs the chunk through
   8192-key tables, within ``WIDE_TABLE_RATIO`` of the chunk's time (the
   staging follows the live keys); ``flash_f32_fma_d32`` holds
   ``flash_fma`` (D 32, outside the tensor-core pairs) on an f32 pool.
   ``telemetry_phase`` then plants +-Inf and
   NaN in live, dead and window-left slots of a bf16 pool (decode mma,
   ``flash_tc`` by TMA) and fills an ``em_fp8`` f32 pool with values
   beyond fp8's range (decode fma, ``flash_tc`` converting), with the
   same gates, and ``nonfinite_phase`` holds the split routes' values on
   operands with +-Inf and NaN against the plain version (NaN, signed Inf
   and finite values alike).
3. Op-path phase: the transprecision op path at gemma2-9b's MLP widths
   (d_model 3584, d_ff 14336).  Each of its kernels (tp_matmul,
   tp_quantize, cast_and_pack, dotp_ex) against its plain version on the
   card: quantize and pack bit for bit, tp_matmul within
   ``2 K 2^-24 (|A| @ |B|)`` plus one output ulp (with its fused snap read
   back bit for bit), dotp_ex within ``1e-5 sum |a b|`` of the exact f64
   sum, and the paper's Table III stream to >= 22 correct bits.  The main
   tp_matmul cases and the split route's (``mm_tf32_grid_small``, two
   pieces; ``mm_fp32_mlp_up``, f32 without a grid at the main shape, three,
   beside ``torch.mm`` in full f32) also time the kept FMA variant and
   hold its output within the same tolerance.
   Then the
   public entry points in sequence — quantize two weights to fp8, two
   ``core.ops.tp_matmul(..., "em_fp8", use_kernel=True)`` products, pack
   them, and the expanding dot product of the two weights — with every
   launch counter > 0 afterwards and both products on the tensor-core
   variant, each at the plan ``kernels.ops`` picked.
3b. Autotune leg (``autotune_phase``): how many shipped winners
   (``kernels/pretuned.json``) the loader adopted for this card and build
   (whether the later phases run tuned), then a sweep of the slice's
   local decode, its 256-token chunk and the MLP down product through
   the tuner into a temporary cache, each candidate held to its plain
   version before it is timed; one default ``kernels.ops`` call must then
   count its launch under the winner.
4. Slice phase: full-width gemma2-9b under ``tp_bf16`` with seeded random
   weights, served by ``ContinuousEngine`` (4 slots, 8 requests, pages of
   64 tokens, one request crossing the 4096-token local window).  Every
   request must get its whole budget and both kernels must have launched
   in that run, every flash launch on the tensor-core variant.  A short
   window (the first four requests, 8 tokens each) under
   ``torch.profiler`` gives device time by kernel class and the device's
   idle share.  Every decode launch must take the mma route, at the
   cluster size ``kernels.ops`` picks for its layer, every ``flash_tc``
   launch at the query tile it picked.  Then one request
   is served again with the plain versions and its first-token logits
   and greedy tokens are compared.
4b. Speculative phase (``speculative_phase``), on the slice's model and
   weights: ``verify_chunk`` against 4 ``decode_step`` calls at full width
   (logit difference, cache bytes that differ), then the slice's queue
   through ``ContinuousEngine(spec_k=3)`` in three runs: (a) a 1-repeat
   draft (2 of 42 layers) with request 1 ``no_speculate`` and request 2
   capped at ``spec_k=1``, (b) the same draft under ``tp_bf16_kv8``, (c)
   the full-depth self-draft on the first four requests, 8 tokens each
   (cut from the whole queue to keep the smoke within its time).  Gates: every request gets its budget, the
   pool drains, each stream equals the slice's plain stream up to its
   first near tie (``near_tie_check``), ``0 < spec_accept_rate <= 1``,
   every decode launch (draft steps and verify folds) at the slice's
   cluster size, every flash launch ``flash_tc`` at 256x256; a repeat of
   run (a) repeats its tokens and ``spec_rounds``, and its
   ``no_speculate`` row emits one token a round.  tok/s, ms per round,
   accept rate and the ratio to the plain slice; run (a)'s busy / idle
   split.
5. Generate phase (``generate_phase``), on the slice's model and weights:
   ``Model.generate`` on a ragged batch of four prompts, greedy with
   penalties and the guard; the while form's tokens must equal the scan
   form's, a one-row stop-token run must exit early in the while form,
   the guard counts must be 0, and prefix sharing must change no token
   and no logit.  Then the prefill and first token again through the
   plain versions: first-token logits within ``LOGITS_TOL``, each row's
   first token equal but at a near tie.  Decode ms per step and tok/s;
   device time by class from a profiled 8-token scan
   (``GEN_PROFILE_LEN``).
6. Overload phase (``overload_phase``), on the first ``FLEET_LAYERS`` =
   14 of the slice model's 42 layers and their weights: the
   overload-safe engine on a short pool with swap preemption, fp8
   degrade, sampling with penalties and a fault plan.  Every request must get its whole budget, every
   overload counter must fire, each injected SDC must be detected, a
   second run must repeat every token, and the schedule must equal a CPU
   run of the same queue at the reduced config.  tok/s, decode ms per
   round, swap bytes, time and GB/s, and the sampling step's device time
   at [4, 256000].
6b. HA phase (``ha_phase``), on the overload phase's 14 layers: a
   meshless ``ReplicatedEngine`` of two replicas (2 slots each, chunk
   256, burst cap 8, one copy of the weights, a pool each) on the
   session trace (12 requests, prompts 256-1548, budgets 4-16): (a)
   unfailed; (b) replica 1 killed at burst 2, reingest migration, an
   in-memory journal; (c) four 512-token residents, replica 0 hung at
   burst 2, dead after 3 missed beats, swap-blob migration; (d) one
   replica with a file journal killed with no survivor and recovered by
   ``run_with_restarts``, a second recovery from a copy of the crashed
   journal, an unfailed run.  Gates: budgets, pools drained, launches on
   their routes, the HA counters and heartbeats, the journal's counts
   and its reload, the two recoveries bitwise equal, and tokens against
   each oracle equal up to a near tie.  tok/s, decode ms per round,
   evacuation ms and migrated bytes, journal bytes and append cost, the
   restart's wall time.
6c. tp phase (``tp_phase``): the slice's model is freed; two ranks
   (``launch.spmd.spawn``) on the one card over gloo, each with its
   shards, against oracles served unsharded in this process first:
   (a) gemma2-9b at full width, ``TP_LAYERS`` = 8 of 42 layers, tensor
   parallel through ``ContinuousEngine(mesh=)`` (4 slots, chunk 256,
   pages of 64, 8 requests of 128-1024 tokens, 16 each): streams bitwise
   across ranks and equal to the oracle's up to a near tie, first-token
   logits within ``LOGITS_TOL``, one layer's decode and prefill reads
   bitwise per head at the unsharded split, decode ``mma`` at G 2 and
   flash ``flash_tc`` on each rank; (b) qwen3-moe at ``TP_MOE_LAYERS`` = 4
   of 48, expert parallel (64 experts a rank) through ``generate`` with
   the oracle's expert choices, the same gates at G 8, and ``moe_block``
   on its first MoE layer against the unsharded call (indices and
   dropped set exact, output within ``KERNEL_TOL`` of its largest
   magnitude); (c) minicpm3-4b (8 of 62) and (d) deepseek-v2-lite (4 of
   27, experts pinned) through ``generate``, each rank's heads of the
   (D, Dv) prefill read bitwise and of the absorbed decode within
   ``KERNEL_TOL``; (e) zamba2-1.2b (8 of 38) and xlstm-1.3b (8 of 48)
   through ``generate``, first-token logits within ``LOGITS_TOL`` or 3x
   the model's own chunk sensitivity; (f) the sharded fleet on a (2, 1)
   mesh, four journaled legs (unfailed, kill, hang with swap migration,
   a double loss replayed by ``run_with_restarts``), streams, schedule,
   heartbeats, ``ha_*`` and the journal's bytes those of the meshless
   2-replica fleet in this process.  tok/s and ms a round sharded and
   unsharded, collectives, their ms and the bytes gloo staged through
   pinned host memory: not a speed of NCCL.
7. Escalation phase (``escalation_phase``): the bf16 model is freed and
   gemma2-9b is built again under policy ``fp32`` (f32 weights, an f32 KV
   pool; ``ESCALATION_LAYERS`` = 8 of its 42 layers: 9.6 GiB), then
   served by the escalation engine (4 slots, chunk
   256, 69 pages of 64; ladder fp8 -> fp16 -> fp16alt at 8 overflow
   flags; overflow injected at rounds 3 and 8) on ``ESCALATION``.  Every
   request gets its budget, escalations >= 1, the ``no_escalate``
   request refuses and stays at rung 0, no non-finite logits, a repeat
   run repeats tokens and events, the schedule equals the reduced
   config's on the CPU, and every launch is on the fma route / the split
   route.  tok/s, decode ms per round, prefill s, the events.
8. MLA phase (``mla_phase``): the fp32 model is freed and minicpm3-4b is
   built at full width under ``tp_bf16`` (MLA with QK head dim 96 and V
   head dim 64; depth cut to ``MLA_LAYERS`` = 16 of 62), then served by ``Model.generate`` from its
   contiguous latent cache on four ragged prompts (1024/768/512/256), 32
   greedy tokens.  Gates: scan == while tokens, every flash launch on
   ``flash_tc`` at (96, 64) and no decode-kernel launch (decode is the
   absorbed form on ``tp_einsum``), first-token logits against the plain
   versions, and the rope check: one 64-token prompt's prefill logits
   against the same prompt fed token by token through ``decode_step``.
   Prefill s, decode ms per step, tok/s.
9. DeepSeek phase (``deepseek_phase``): minicpm3 is freed and
   deepseek-v2-lite-16b is built at full width under ``tp_bf16`` (MLA
   with QK head dim 192 and V 128, layer 0 dense, then MoE layers of 64
   experts top-6 plus 2 shared; depth cut to ``DEEPSEEK_LAYERS`` = 7 of
   27, 15.5 GiB), then served by
   ``Model.generate`` as in the MLA phase.  Gates: scan == while, every
   flash launch ``flash_tc`` at (192, 128) (none ``flash_fma``), no decode
   kernel launch, first-token logits within ``LOGITS_TOL`` of the plain
   versions and the rope check, both with the plain / token-by-token pass
   routed to the kernel pass's experts (``RouteTape``: bf16 differences
   flip near-tied router choices, which is not the kernels' doing; the
   free-routing difference and the flipped choices are reported).
10. MoE phase (``moe_phase``): deepseek is freed and qwen3-moe-30b-a3b is
   built at full width under ``tp_bf16`` (32 / 4 heads of 128, 128
   experts top-8; depth cut to ``MOE_LAYERS`` = 8 of 48, 10.8 GiB; all
   48 take 56.9 GiB, the whole card), then serves the
   slice's queue through ``ContinuousEngine`` (4 slots, chunk 256, pages
   of 64).  Gates: budgets, the pool drains, every decode launch ``mma``
   at the cluster size ``kernels.ops`` picks, every flash launch ``flash_tc`` at (128,
   128); request 2 against the plain versions (routing pinned, as above;
   greedy tokens equal up to a near tie); a window under ``tp_bf16_kv8``
   (the fp8 pool); one speculative run on that window (``spec_k`` 3, a
   1-layer draft) whose streams equal the plain run's up to a near tie,
   with an accept rate in (0, 1].  A profiled window gives device time
   by class with ``moe_dispatch`` (sort, searchsorted, scatter, gather),
   and one layer's FFN is timed alone at 4, 16 and 256 rows
   (``moe_layer_probe``: host and device ms, the bound of the padded
   slabs and of the routed experts alone).  Each MoE phase logs the
   card's free memory first and fails below its need.
11. Granite phase (``granite_phase``): qwen3-moe is freed and
   granite-20b is built at full width under ``tp_bf16`` (48 query heads
   on one KV head of 128 (MQA: group 48), a gelu MLP with biases, d_ff
   24576), its depth cut to ``GRANITE_LAYERS`` = 13 of 52 layers, then
   serves the slice's queue through
   ``ContinuousEngine`` (4 slots, chunk 256, pages of 64).  Gates:
   budgets, the pool drains, every decode launch ``mma`` at group 48
   and at the cluster size ``kernels.ops`` picks, every flash launch ``flash_tc`` at
   (128, 128); request 2 against the plain versions (first-token logits
   within ``LOGITS_TOL``, greedy tokens equal up to a near tie); a window
   (4 requests x 8 tokens) under ``tp_bf16_kv8`` with the same gates.
   tok/s, decode ms a round against the weight-read bound, prefill, and
   device busy / idle from a profiled window.
12. gemma3 phase (``gemma3_phase``): granite is freed and gemma3-12b is
   built at full width under ``tp_bf16`` (16 query heads on 8 KV heads of
   256, window 1024 on 5 of every 6 layers, qk-norm, sandwich norms, no
   softcap, vocab 262144; ``GEMMA3_LAYERS`` = 6 of 48: one repeat of
   the pattern), paged in 64-token pages, and serves the slice's queue
   through ``ContinuousEngine`` (``engine_arch_phase``, as granite's):
   budgets, drained pool, every decode launch ``mma`` at group 2 and at
   the cluster size ``kernels.ops`` picks, every flash launch ``flash_tc`` at (256,
   256), a profiled window, request 2 against the plain versions.
13. internvl2 phase (``internvl2_phase``): internvl2-26b at full width
   (48 query heads on 8 KV heads of 128: group 6; d_ff 16384, vocab
   92553, untied; ``INTERNVL2_LAYERS`` = 8 of 48), paged, through
   ``Model.generate`` on 4 ragged rows (1024 / 768 / 512 / 300) with
   seeded patch embeddings [4, 256, 6144], 32 greedy tokens
   (``generate_arch``): every decode launch ``mma`` at group 6, every
   flash launch ``flash_tc`` at (128, 128), first-token logits within
   ``LOGITS_TOL`` of the plain versions' and the streams equal up to a
   near tie (``stream_near_ties``), a profiled scan; other patch
   embeddings must move the first-token logits by more than
   ``2 LOGITS_TOL``.
14. whisper phase (``whisper_phase``): whisper-small at full width and
   depth (12 encoder and 12 decoder layers, d 768, 12 heads of 64, d_ff
   3072, vocab 51865, 1500 frames, learned positions, layernorm; gains,
   shifts and biases drawn by ``_lively_norms``, since the JAX package's
   init zeroes a layernorm's gain) through ``Model.generate`` on 4 rows
   of short ragged prompts with seeded frame embeddings [4, 1500, 768],
   32 greedy tokens (``generate_arch`` at group 1 and (64, 64)); each
   prefill launches flash without the causal mask once an encoder layer
   and once a cross-attention layer (``launches_noncausal``); the
   encoder states and every layer's cross cache within ``ENCODER_TOL``
   of the plain path's.
15. zamba2 phase (``zamba2_phase``): whisper is freed and zamba2-1.2b
   is built at full width under ``tp_bf16`` (``ZAMBA2_LAYERS`` = 20 of 38
   layers: 17 Mamba2 mixers, d_model 2048, d_inner 4096, 64 heads of 64,
   d_state 64, chunk 256, and one shared attention + SwiGLU block, 32
   heads of 64, d_ff 8192, read at 3 positions, each with its own
   contiguous KV cache), then served by ``Model.generate`` on 4 rows of 1000 tokens
   (equal lengths: recurrent mixers refuse ragged prompts), 32 greedy
   tokens (``generate_arch``: decode ``mma`` at group 1, flash
   ``flash_tc`` at (64, 64), first-token logits and streams against the
   plain versions).  Gates of its own: the launches are the 3 shared
   layers times the calls, all causal; the continuation gate
   (``continuation_gate``: one row under ``fp32``, 8 ``decode_step``
   calls after the prefill against the prefill of the longer prompt,
   within ``CONT_TOL``).  Each row's recurrent state and KV bytes.
16. xlstm phase (``xlstm_phase``): zamba2 is freed and xlstm-1.3b is
   built at full width under ``tp_bf16`` (``XLSTM_LAYERS`` = 24 of 48
   layers: 21 mLSTM mixers, 4 heads of 1024, chunk 256, and 3 sLSTM
   mixers, a sequential
   loop over time with a gated gelu FFN tail), then served by
   ``Model.generate`` on 4 rows of 600 tokens, 32 greedy tokens: no
   attention kernel may launch; the continuation gate; state bytes.
   Both recurrent phases profile the scan by class, with f32-output GEMMs
   on CUDA cores (``gemm_f32``) apart from the tensor-core GEMMs.
17. Train phase (``train_phase``; it needs no kernel, so ``main`` runs
   it in a process of its own beside the build, on the card that the
   build leaves idle): full-width fpnew-case-study (12 layers, d_model
   768, 12 heads of 64, d_ff 2048, vocab 32000, tied: 109.6M
   parameters) trains through ``TrainLoop``
   from seed-0 port weights on the JAX launcher's defaults (seq 256,
   batch 16, lr 3e-3, warm-up 10, AdamW): (a) ``tp_bf16`` for 100 steps
   with checkpoints every 40 in a temporary directory, (b) ``fp32`` and
   (c) ``em_fp8`` for ``TRAIN_OTHERS`` steps (without remat: the same
   gradients bit for bit), (d) (a)'s first 60 steps
   with a failure at step 50 under ``run_with_restarts``; (a) and (d)
   under ``torch.use_deterministic_algorithms(True)``.  Gates: losses and
   gradient norms finite, each run's last-5 mean loss 0.5 below its
   first-5, (d) resumes at step 40 and its state at step 60 equals (a)'s
   bit for bit, a checkpoint restores bit for bit, and no hand-written
   kernel launches (training attention is the dense path: the kernels
   have no backward).  ms a step and tokens/s, a profiled 5-step window
   (busy / idle; gemm / attention / optimizer / other by launching op),
   checkpoint GB and save / restore seconds.
18. Training under a mesh (``train_mesh_phase``; it needs no kernel, so
   ``main`` runs it in a thread beside the build and the train phase):
   two gloo ranks on the one card (not NCCL), the same model and
   settings as the train phase: (e) dp (2, 1) with the plain f32 sync,
   10 steps (the first step's loss, gradient norm and update against
   the unsharded step on the whole batch, the losses against the
   unsharded run's), (f) the fp8 and fp16alt compressed sync, 10 steps
   each (losses within ``TRAIN_MESH_BAND`` of (e) and well inside the
   gap of a run without updates, the first gradient norm as (e)'s,
   error feedback nonzero after step 1, 2 bytes a parameter on the
   wire), (g)
   tp (1, 2), 5 steps (every leaf's gradient gathered whole against the
   unsharded step's), (h) ZeRO-1 through the ``jit_train_step`` twin,
   params bitwise (e)'s at step 3, (i) (e)'s step-5 checkpoint restored
   under (1, 2) and under no mesh, bitwise, 3 more steps each tracking
   the unsharded run.  No hand-written kernel launches on any rank.
   The other archs under a training mesh (``train_mesh_archs_phase``,
   two gloo ranks spawned once, in a second thread: (l)–(o) beside the
   fpnew mesh phase, (j)–(k) once it and the unsharded training phase
   have ended; full widths cut in
   depth, ``tp_bf16``, seq 256, global batch 4, one step a leg and
   mesh): (j) qwen3-moe 1 layer at (1, 2), expert parallel;
   (k) deepseek-v2-lite 2 layers at (2, 1) (the MoE aux over the global
   batch) and (1, 2); (l) minicpm3 4 layers, (m) zamba2 5 Mamba2 layers
   and the shared block, (n) xlstm one pattern and (o) whisper-small 12
   + 12 at (1, 2), xlstm under ``fp32``.  The step against rank 0's
   unsharded step (routes pinned): loss, every leaf's gradient and
   update over the whole leaf, the MoE aux; ms a step, collectives,
   staged and wire bytes and state bytes a rank.
18b. The tooling.  The dry-run leg (``dryrun_leg_start``): a
   CPU process started before the build (no card visible to it) runs
   ``launch.dryrun.run_cell`` for gemma2-9b ``decode_32k`` on pod1 and
   pod2 (rank 0's peak bytes, flops, collectives; the benchmark twin's
   ``shard_dryrun_*`` figures), joined at the end.  The energy leg
   (``energy_phase``, after training, the card otherwise idle): a GEMM
   loop per format (8192^3; fp32 with TF32 off, bf16, fp16, fp8 by
   ``torch._scaled_mm``) and a 2 GiB device copy, each 1 s to settle and
   3 s measured while ``nvidia-smi -lms 100`` samples ``power.draw``: pJ
   per flop and per byte (board power above idle over rate), the idle
   power before,
   the card's ``total_memory`` (``core/energy.py`` and ``core/hw.py``
   hold the values read).  The dry-run card check (``dryrun_card_phase``,
   on the slice's weights before the slice): gemma2-9b's decode step
   with the dense backends, 2 rows against a 32768-token cache, on the
   card against its dry run on meta tensors: flops and argument bytes
   equal, the step's own peak (peak less arguments) within
   ``DRYRUN_PEAK_TOL`` of the dry run's.  The example twins
   (``examples_phase``, in a thread from the build's end while the
   training phases finish, joined before the energy leg):
   ``torch_quickstart.py`` and
   ``torch_serve_decode.py --decode-backend kernel`` on the card, each
   in a process, the latter's decode and flash launches > 0.
19. The kernels line (all six kernels; flash attention, tp_matmul and decode
   attention with their launches by variant, the FMA variant's time,
   decode's launches by cluster size, flash's by head dims, the flags-on
   time of the main case and of the telemetry cases, the f32-pool case,
   the MLA cases, the verify case, the qwen3 and granite cases and the
   (192, 128) case with SDPA's time; decode's launches by group; the
   attention launches summed over the slice, speculative, generate,
   overload, HA, escalation, MLA, DeepSeek, MoE and granite phases, and
   the granite phase's own; the gemma3, internvl2, whisper and zamba2
   cases (``arch_cases``) and each arch phase's launches, xlstm's none;
   flash launches without the causal mask), the card line, and as the
   last
   line ``{"ok": true, "device": {...}}``.  The tp phase's launches (both
   ranks') count with the serving paths' and stand alone as
   ``tp_launches``.

Imports no JAX.  Needs one CUDA device and ``nvcc`` (``CUDA_HOME``, PATH
or ``/usr/local/cuda``).
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import multiprocessing as mp
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor, wait as wait_futures

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM dense peaks (NVIDIA data sheet): HBM3 bytes/s, bf16 / fp16 and
#: fp8 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
FP8_FLOP_S = 1979e12
F32_FLOP_S = 67e12

#: kernel-vs-plain tolerance: both sum in f32 and round p to bf16 before
#: p.V; a summation-order difference can flip one such rounding, worth up
#: to 2^-8 of a unit-scale output
KERNEL_TOL = 2.0 ** -8

#: kernel-vs-plain tolerance on an f32 pool (policy ``fp32``: no rounding
#: of p, only f32 sums in another order; each of up to ~4096 terms is
#: off by at most 2^-24 of the running sum, so 2^-12 of a unit-scale
#: output bounds the worst case; about 1e-5 is expected)
F32_TOL = 2.0 ** -12
#: the split route through a block table 8x wider than its live keys may
#: take at most this many times the chunk's own table (it stages only the
#: keys a query sees)
WIDE_TABLE_RATIO = 1.5

#: the softcap's effect in the cap-region cases (q scaled by ``q_scale``):
#: the kernel's capped and uncapped outputs must differ by at least this,
#: far above ``KERNEL_TOL``, so a kernel that skipped or misplaced the cap
#: would fail its comparison with the plain version
CAP_EFFECT_MIN = 64 * KERNEL_TOL

#: first-token logits, kernel path vs plain path, full-width model: the
#: bf16 residual stream carries last-bit differences through 42 layers;
#: 3x the 0.106 measured on an H100 (|logits| <= 7.1 there)
LOGITS_TOL = 0.3

KERNELS = {
    "decode_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:196"),
    "flash_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:201"),
    "tp_matmul": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/tp_matmul.cu",
        replaces="src/repro/kernels/tp_matmul.py:61"),
    "tp_quantize": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/tp_quant.cu",
        replaces="src/repro/kernels/tp_quant.py:40"),
    "cast_and_pack": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/tp_quant.cu",
        replaces="src/repro/kernels/tp_quant.py:63"),
    "dotp_ex": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/dotp_ex.cu",
        replaces="src/repro/kernels/dotp_ex.py:43"),
}


#: the autotuner op that picks each kernel's launch knob
OP_OF_KERNEL = {"decode_attention": "decode_attn", "flash_attention": "attn",
                "tp_matmul": "matmul"}

#: libraries with a tensor-core (wgmma) variant
TC_LIBRARIES = ("flash_attention", "tp_matmul")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, calls: int = 10, replays: int = 3) -> float:
    """Device time of one ``fn()`` call: ``calls`` calls captured into one
    CUDA graph and replayed ``replays`` times between CUDA events, so the
    host's launch overhead (the Python wrapper, tensor-map encoding, the
    ctypes call) is not counted.  Warm-up calls run first on a side stream,
    as capture requires."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / (calls * replays)
    del graph
    return ms


def bound(nbytes: float, flops: float, flop_s: float = BF16_FLOP_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flop_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------
def split_passes(pieces: int, top: int = 2) -> int:
    """Tensor-core passes of one split product whose operands both take
    ``pieces`` pieces: its kept piece pairs (``quant_common.split_pairs``;
    ``top`` 1: flash's P V), each a full product at the bf16 rate."""
    from repro_torch.kernels.quant_common import split_pairs
    return len(split_pairs(pieces, pieces, top))


def flash_variant_counts() -> dict:
    """``flash_attention_cuda``'s launches by variant so far."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda as c
    return {"tc": c.launches_tc, "split": c.launches_split,
            "fma": c.launches_fma}


def matmul_variant_counts() -> dict:
    """``tp_matmul_cuda``'s launches by variant so far."""
    from repro_torch.kernels.tp_matmul import tp_matmul_cuda as c
    return {"tc": c.launches_tc, "split": c.launches_split,
            "fma": c.launches_fma}


def hgmma_count(lib) -> int:
    """``HGMMA`` (wgmma) instructions in a built library's SASS."""
    from repro_torch.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return sum(1 for ln in sass.splitlines() if "HGMMA" in ln)


def build_phase():
    """Builds every library, then starts counting each one's ``HGMMA``
    instructions in the background (``cuobjdump`` takes tens of seconds
    on the flash library, which the kernel phase need not wait for).
    Returns the gate: a call that waits for the counts, logs them, fails
    unless both tensor-core libraries contain wgmma instructions, and
    returns {library: HGMMA count}."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    for name, entry in logs.items():
        lines = entry["log"].splitlines()
        ptxas = [ln.strip() for ln in lines
                 if "registers" in ln or "spill" in ln]
        # entry functions whose build spills registers to local memory
        spills, fn = [], None
        for ln in lines:
            if "Compiling entry function" in ln:
                fn = ln.split("'")[1] if "'" in ln else ln
            elif "spill" in ln and not ln.strip().startswith(
                    "0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                    "spill loads"):
                spills.append([fn, ln.strip()])
        log(json.dumps({"build": name, "seconds": round(entry["seconds"], 2),
                        "ptxas": ptxas[:16], "spilling": spills[:24]}))
    log(f"kernels built in {secs:.1f} s")
    pool = ThreadPoolExecutor(len(_build.KERNELS))
    counts = {name: pool.submit(hgmma_count, _build.library_path(name))
              for name in _build.KERNELS}
    pool.shutdown(wait=False)

    def gate() -> dict:
        hgmma = {name: f.result() for name, f in counts.items()}
        log(json.dumps({"hgmma_instructions": hgmma}))
        for name in TC_LIBRARIES:
            if hgmma[name] <= 0:
                raise AssertionError(f"{name}: no HGMMA instruction in its "
                                     f"build")
        return hgmma
    return gate


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------
def pool_policy(dtype) -> str:
    """The serving policy whose KV pool stores ``dtype``."""
    import torch
    return {torch.bfloat16: "tp_bf16", torch.float8_e5m2: "tp_bf16_kv8",
            torch.float32: "fp32"}[dtype]


def _bits_equal(a, b) -> bool:
    """Bitwise equality of two f32 tensors, NaN payloads included."""
    import torch
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def decode_telemetry(name, args, kw, variant, cluster=None) -> dict:
    """The decode kernel's telemetry instantiation on the flat arguments
    ``args`` / ``kw`` of ``decode_attention_cuda`` at ``cluster`` CTAs a
    row: its output must be bitwise the flags-off output, its visits and
    flags exactly the plain version's, and the launch must count on route
    ``variant``.  Returns the flags-on device ms and the counts."""
    import functools
    import torch
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_plain)
    cu = functools.partial(decode_attention_cuda, cluster=cluster)
    off = cu(*args, **kw)
    dc = decode_attention_cuda
    before = (dc.launches_telemetry, dc.launches_mma, dc.launches_fma)
    on, visits, flags = cu(*args, debug_visits=True, debug_flags=True, **kw)
    routed = (dc.launches_telemetry - before[0], dc.launches_mma - before[1],
              dc.launches_fma - before[2])
    _, pv, pf = decode_attention_plain(*args, debug_visits=True,
                                       debug_flags=True, **kw)
    torch.cuda.synchronize()
    if routed != ((1, 1, 0) if variant == "mma" else (1, 0, 1)):
        raise AssertionError(f"{name}: telemetry launches (flags, mma, fma) "
                             f"{routed}, expected the {variant} route")
    same = _bits_equal(on, off)
    rec = dict(flags_ms=device_ms(lambda: cu(*args, debug_visits=True,
                                             debug_flags=True, **kw)),
               flags_bitwise_output=same,
               visits_equal=torch.equal(visits, pv),
               flags_equal=torch.equal(flags, pf),
               flag_totals=flags.sum((0, 1)).tolist(),
               visited_cells=int(visits.sum()))
    if not (same and rec["visits_equal"] and rec["flags_equal"]):
        raise AssertionError(f"{name}: telemetry {rec}")
    return rec


def flash_telemetry(name, args, kw, variant) -> dict:
    """``decode_telemetry`` for ``flash_attention_cuda`` (``kw`` may hold
    ``flash_tc``'s ``q_rows``): the plain version walks the variant's own
    tiles (``kernel_tiles``)."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain, kernel_tiles)
    cu = flash_attention_cuda
    q, v = args[0], args[2]
    bq, bk = kernel_tiles(kw["src_dtype"], kw.get("src_fmt_name"),
                          q.shape[1], q.shape[0] // kw["group"],
                          kw["group"], q.shape[2], v.shape[-1],
                          q_rows=kw.get("q_rows"))
    plain_kw = {k: x for k, x in kw.items() if k != "q_rows"}
    off = cu(*args, **kw)
    before = (cu.launches_telemetry, flash_variant_counts())
    on, visits, flags = cu(*args, debug_visits=True, debug_flags=True, **kw)
    routed = (cu.launches_telemetry - before[0],
              {v: n - before[1][v] for v, n in flash_variant_counts().items()})
    _, pv, pf = flash_attention_plain(*args, block_k=bk, block_q=bq,
                                      debug_visits=True, debug_flags=True,
                                      **plain_kw)
    torch.cuda.synchronize()
    if routed != (1, {v: int(v == variant) for v in routed[1]}):
        raise AssertionError(f"{name}: telemetry launches (flags, by "
                             f"variant) {routed}, expected the {variant} "
                             f"variant")
    same = _bits_equal(on, off)
    rec = dict(flags_ms=device_ms(lambda: cu(*args, debug_visits=True,
                                             debug_flags=True, **kw)),
               flags_bitwise_output=same,
               visits_equal=torch.equal(visits, pv),
               flags_equal=torch.equal(flags, pf),
               flag_totals=flags.sum((0, 1)).tolist(),
               visited_cells=int(visits.sum()), tiles=[bq, bk])
    if not (same and rec["visits_equal"] and rec["flags_equal"]):
        raise AssertionError(f"{name}: telemetry {rec}")
    return rec


def _pool_and_table(gen, b, hkv, max_pages, page, d, dtype, alias: int):
    """A shuffled page pool [n_pages, Hkv, page, D] (pool dtype ``dtype``)
    and a [b, max_pages] table; rows 0 and 1 share their first ``alias``
    pages (a common prefix)."""
    import torch
    n_pages = b * max_pages + 1
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    table = perm[:b * max_pages].reshape(b, max_pages).to(torch.int32)
    if alias and b > 1:
        table[1, :alias] = table[0, :alias]
    k = torch.randn((n_pages, hkv, page, d), generator=gen, device="cuda")
    v = torch.randn((n_pages, hkv, page, d), generator=gen, device="cuda")
    return k.to(dtype), v.to(dtype), table


def _keys_read(table, page, skv, lo, hi):
    """Distinct K/V positions the function must read: row ``r`` reads keys
    ``lo[r] <= idx < hi[r]``, through ``table`` [B, max_pages] (a page
    shared by two rows counts once) or, with ``table`` None, from its own
    contiguous strip of ``skv`` keys.  One position holds every KV head."""
    import torch
    idx = torch.arange(skv, device="cuda")[None, :]
    live = (idx >= lo[:, None]) & (idx < hi[:, None])
    if table is None:
        pos = torch.arange(len(lo), device="cuda")[:, None] * skv + idx
    else:
        pos = table.long()[:, idx[0] // page] * page + idx % page
    return int(torch.unique(pos[live]).numel())


def _cap_effect(call, got):
    """Largest change the softcap makes to the kernel's output."""
    return (got - call("kernel", None)).abs().max().item()


def _sdpa_decode(q, k_pool, v_pool, table, kv_len, window):
    """The library yardstick for decode: ``scaled_dot_product_attention``
    on the gathered contiguous cache (``table`` None: the contiguous
    cache as it is) with a boolean live-key mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.paged import gather_paged_kv
    kc, vc = ((x if table is None else gather_paged_kv(x, table)).to(q.dtype)
              for x in (k_pool, v_pool))
    idx = torch.arange(kc.shape[2], device="cuda")[None, :]
    mask = idx < kv_len[:, None]
    if window is not None:
        mask &= idx > kv_len[:, None] - 1 - window
    mask = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask,
                                                  enable_gqa=True)


def decode_case(name, *, dtype, page, kv_lens, window, softcap, alias,
                seed, q_scale=1.0, heads=(8, 2), d=256, strip=None):
    """Decode over ``heads`` = (KV heads, group) of head dim ``d``, through
    a page pool of ``page``-token pages or, with ``page == 0``, over
    contiguous strips of ``strip`` keys (None: the longest row + 1; the
    kernel splits a strip into 64-key units).
    ``q_scale`` > 1 puts the scores into the softcap's bend; the case
    then also checks that the cap changes the output (``CAP_EFFECT_MIN``).
    The launch must count under the cluster size ``kernels.ops`` picks
    (``cluster_tuned``: a winner of the tuner made it, else
    ``cluster_size``).  Without a softcap SDPA computes the same function
    (``library_ms``; an idle row, whose output the kernel stores as 0, is
    NaN there)."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.decode_attention import (
        STRIP_UNIT, cluster_size, decode_attention_cuda, decode_route)
    b, (hkv, g) = len(kv_lens), heads
    gen = torch.Generator(device="cuda").manual_seed(seed)
    max_len = max(kv_lens) + 1
    if page:
        max_pages = -(-max_len // page)
        k, v, table = _pool_and_table(gen, b, hkv, max_pages, page, d, dtype,
                                      alias)
        unit, units, skv = page, max_pages, max_pages * page
    else:
        skv = strip or max_len
        k, v = (torch.randn((b, hkv, skv, d), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        table, unit, units = None, STRIP_UNIT, -(-skv // STRIP_UNIT)
    policy = pool_policy(dtype)
    q = (torch.randn((b, hkv * g, 1, d), generator=gen, device="cuda")
         * q_scale).to(torch.float32 if policy == "fp32" else torch.bfloat16)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    call = lambda backend, cap=softcap: kops.decode_attention(
        q, k, v, kv_len=kvl, block_table=table, policy=policy,
        window=window, softcap=cap, backend=backend)
    src_dt, _ = kops.policy_src(policy)
    variant = decode_route(src_dt, d)
    by_cluster = decode_attention_cuda.launches_by_cluster
    before = (decode_attention_cuda.launches_mma,
              decode_attention_cuda.launches_fma, dict(by_cluster))
    got = call("kernel")
    routed = (decode_attention_cuda.launches_mma - before[0],
              decode_attention_cuda.launches_fma - before[1])
    ran = [c for c, n in by_cluster.items() if n != before[2].get(c, 0)]
    want = call("plain")
    torch.cuda.synchronize()
    if routed != ((1, 0) if variant == "mma" else (0, 1)):
        raise AssertionError(f"{name}: launches (mma, fma) {routed}, "
                             f"expected the {variant} route")
    rule, tuned = kops.decode_cluster(b, k, table, window, group=g,
                                      with_source=True)
    if ran != [rule]:
        raise AssertionError(f"{name}: launch counted under cluster sizes "
                             f"{ran}, kernels.ops picks {rule}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs().max().item()
    cap = _cap_effect(call, got) if q_scale != 1.0 else None
    live = [min(n, n if window is None else window) for n in kv_lens]
    lo = (torch.zeros_like(kvl) if window is None
          else torch.clamp(kvl - window, min=0))
    keys = _keys_read(table, page, skv, lo, kvl)
    esz = k.element_size()
    nbytes = (q.numel() * q.element_size() + keys * hkv * d * 2 * esz
              + got.numel() * 4 + kvl.numel() * 4
              + (table.numel() * 4 if page else 0))
    flops = 4.0 * g * d * hkv * sum(live)
    bound_ms, bound_by = bound(nbytes, flops,
                               BF16_FLOP_S if variant == "mma" else F32_FLOP_S)
    tol = F32_TOL if policy == "fp32" else KERNEL_TOL
    lib = None
    if softcap is None:
        lib = device_ms(_sdpa_decode(q, k, v, table, kvl, window))
    flat = lambda x: x.reshape(-1, page or skv, d)
    lens = kops.expand_kv_lens(kvl, b, hkv, skv, q.device)
    flat_tab = kops.expand_block_table(table, hkv) if page else None
    args = (q.reshape(b * hkv, g, d), flat(k), flat(v), lens, flat_tab)
    kw = dict(scale=d ** -0.5, window=window, softcap=softcap,
              src_dtype=src_dt)
    kernel_only = device_ms(lambda: decode_attention_cuda(
        *args, cluster=rule, **kw))
    tele = decode_telemetry(name, args, kw, variant, rule)
    static = cluster_size(b * hkv, units, unit, window)
    if static != rule:
        tele["rule_ms"] = device_ms(lambda: kops.decode_attention(
            q, k, v, kv_len=kvl, block_table=table, policy=policy,
            window=window, softcap=softcap, backend="kernel",
            cluster=static))
    rec = dict(case=name, kernel="decode_attention", variant=variant,
               cluster=ran[0], cluster_tuned=tuned, cluster_rule=static,
               ctas=b * hkv * ran[0], max_abs_err=err,
               tol=tol, q_scale=q_scale, cap_effect=cap,
               kernel_ms=device_ms(lambda: call("kernel")),
               kernel_only_ms=kernel_only, **tele,
               eager_ms=cuda_ms(lambda: call("kernel"), 20),
               plain_ms=cuda_ms(lambda: call("plain"), 5),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
               shape=dict(slots=b, hkv=hkv, group=g, d=d, page=page,
                          strip=None if page else skv,
                          kv_len=kv_lens, window=window, softcap=softcap,
                          pool=str(dtype).replace("torch.", "")))
    log(json.dumps(rec))
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    if cap is not None and not cap >= CAP_EFFECT_MIN:
        raise AssertionError(f"{name}: the softcap changes the output by "
                             f"{cap} < {CAP_EFFECT_MIN}")
    return rec


def verify_case(name="decode_bf16_p64_verify", seed: int = 14) -> dict:
    """The speculative verify read: 4 slots x (SPEC_K + 1) chunk positions
    x 8 KV heads on a local layer (window 4096, softcap 50) over the
    speculative phase's 65-page tables, query i of slot b at ``kv_len =
    pos_b + i + 1`` with ``pos`` the slice's first four prompt lengths.
    The fold (128 rows) at the step form's partition (``decode_cluster``
    of the 4 slots, the size ``kernels.ops`` picks: by the static rule 16
    CTAs a row) must be BITWISE the 4 step-form kernel calls, and within
    ``KERNEL_TOL`` of the plain version at the same partition.  Times: the
    fold at the step partition and at its own (by the rule 4), the 4 step
    calls, SDPA without softcap over the 4 slots' gathered cache with a
    per-query mask (the library's multi-query read)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.models.paged import gather_paged_kv
    b, s, hkv, g, d, page, window = 4, SPEC_K + 1, 8, 2, 256, 64, 4096
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pos = torch.tensor(PROMPTS[:b], device="cuda")
    max_pages = -(-(max(PROMPTS) + GEN + SPEC_K) // page)
    k, v, table = _pool_and_table(gen, b, hkv, max_pages, page, d,
                                  torch.bfloat16, alias=0)
    q = torch.randn((b, s, hkv * g, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    kvl = pos[:, None] + torch.arange(s, device="cuda") + 1      # [b, s]
    qf = q.reshape(b * s, hkv * g, 1, d)
    tf, lf = table.repeat_interleave(s, 0), kvl.reshape(-1)
    step_c = kops.decode_cluster(b, k, table, window, group=g)
    own_c = kops.decode_cluster(b * s, k, tf, window, group=g)
    if (step_c, own_c) != tuple(kops.decode_pick(
            r * hkv, max_pages, page, g, d, torch.bfloat16, "cuda", window)
            for r in (b, b * s)):
        raise AssertionError(f"{name}: decode_cluster {step_c}/{own_c}")
    kw = dict(policy="tp_bf16", window=window, softcap=50.0)
    fold = lambda backend="kernel", c=step_c: kops.decode_attention(
        qf, k, v, kv_len=lf, block_table=tf, backend=backend, cluster=c,
        **kw)
    steps = lambda: [kops.decode_attention(
        q[:, i, :, None], k, v, kv_len=kvl[:, i], block_table=table,
        backend="kernel", **kw) for i in range(s)]
    by_cluster = decode_attention_cuda.launches_by_cluster
    before = dict(by_cluster)
    got = fold()
    ran = {c: n - before.get(c, 0) for c, n in by_cluster.items()
           if n != before.get(c, 0)}
    want = torch.stack([o[:, :, 0] for o in steps()], 1)
    plain = fold("plain")
    torch.cuda.synchronize()
    got4 = got.reshape(b, s, hkv * g, d)
    bitwise = _bits_equal(got4, want)
    err = (got - plain).abs().max().item()
    if ran != {step_c: 1}:
        raise AssertionError(f"{name}: the fold launched at {ran}, not at "
                             f"the step partition {step_c}")
    if not bitwise:
        raise AssertionError(f"{name}: the fold differs from the step-form "
                             f"reads by {(got4 - want).abs().max().item()}")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"{name}: max_abs_err {err} > {KERNEL_TOL}")
    # bytes: q, each live key of each slot once (all KV heads, K and V),
    # the f32 output, the lengths and the tables the fold reads
    lo = torch.clamp(kvl[:, 0] - window, min=0)
    keys = _keys_read(table, page, max_pages * page, lo, kvl[:, -1])
    nbytes = (q.numel() * 2 + keys * hkv * d * 2 * 2 + got.numel() * 4
              + lf.numel() * 4 + tf.numel() * 4)
    live = torch.minimum(kvl, torch.tensor(window, device="cuda"))
    flops = 4.0 * g * d * hkv * int(live.sum())
    bound_ms, bound_by = bound(nbytes, flops)
    kc = gather_paged_kv(k, table)
    vc = gather_paged_kv(v, table)
    idx = torch.arange(kc.shape[2], device="cuda")
    mask = ((idx[None, None, :] < kvl[:, :, None])
            & (idx[None, None, :] > kvl[:, :, None] - 1 - window))[:, None]
    qs = q.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(qs, kc, vc, attn_mask=mask,
                                                  enable_gqa=True)
    rec = dict(case=name, kernel="decode_attention", variant="mma",
               cluster=step_c, fold_own_cluster=own_c, bitwise_vs_steps=True,
               max_abs_err=err, tol=KERNEL_TOL,
               kernel_ms=device_ms(fold),
               own_cluster_ms=device_ms(lambda: fold(c=own_c)),
               steps_ms=device_ms(steps), plain_ms=cuda_ms(
                   lambda: fold("plain"), 3),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               sdpa_nocap_ms=device_ms(sdpa),
               shape=dict(slots=b, positions=s, hkv=hkv, group=g, d=d,
                          page=page, pages=max_pages, pos=PROMPTS[:b],
                          window=window, softcap=50.0))
    log(json.dumps(rec))
    return rec


def _flat_flash(q, k, v, kvl, table, policy):
    """The flattened arguments ``kernels.ops.flash_attention`` hands to the
    kernels (head rows, flat pools, per-head page ids), for timing each
    variant alone."""
    from repro_torch.kernels import ops as kops
    b, h, sq, d = q.shape
    if table is not None:
        n_pages, hkv, page, _ = k.shape
        kf, vf = (x.reshape(n_pages * hkv, page, x.shape[-1]) for x in (k, v))
        tab, skv = kops.expand_block_table(table, hkv), table.shape[1] * page
    else:
        _, hkv, skv, _ = k.shape
        kf, vf = (x.reshape(b * hkv, skv, x.shape[-1]) for x in (k, v))
        tab = None
    src_dt, src_fmt = kops.policy_src(policy)
    args = (q.reshape(b * h, sq, d), kf, vf,
            kops.expand_kv_lens(kvl, b, h, skv, q.device), tab)
    kw = dict(group=h // hkv, scale=d ** -0.5, src_fmt_name=src_fmt,
              src_dtype=src_dt)
    return args, kw


def _sdpa_chunk(q, k, v, table, kvl, q_offset, window=None, causal=True):
    """The library yardstick for a prefill chunk without softcap:
    ``scaled_dot_product_attention`` on the gathered contiguous cache
    (``table`` None: K/V as they are), with the live-key, causal and
    window masks as one boolean mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.paged import gather_paged_kv
    kc, vc = ((x if table is None else gather_paged_kv(x, table)).to(q.dtype)
              for x in (k, v))
    key = torch.arange(kc.shape[2], device="cuda")[None, None, :]
    qpos = q_offset + torch.arange(q.shape[2], device="cuda")[None, :, None]
    mask = key < kvl[:, None, None]
    if causal:
        mask = mask & (key <= qpos)
    if window is not None:
        mask = mask & (qpos - key < window)
    return lambda: F.scaled_dot_product_attention(
        q, kc, vc, attn_mask=mask[:, None], enable_gqa=True)


def flash_case(name, *, dtype, page, rows, q_offset, chunk, window,
               softcap, alias, seed, q_scale=1.0, policy=None, heads=(8, 2),
               d=256, dv=None, main=False, pages=None, causal=True,
               keys=None):
    """A prefill chunk of width ``chunk`` at ``q_offset`` for ``rows``
    live chunk lengths, through the paged pool (``page`` > 0, tables of
    ``pages`` columns, by default just enough for the chunk) or, with
    ``page == 0``, over contiguous K/V (fresh prompt, q_offset 0; V of
    head dim ``dv``, None: ``d``) of ``keys`` positions (None: ``chunk``).
    ``causal=False`` (whisper's encoder and cross-attention): every query
    reads every live key, ``rows`` then the live keys of each row.
    ``q_scale`` as in :func:`decode_case`.  The plain version walks the
    kernel's own key tiles.  A ``flash_tc`` launch must count under the
    query tile ``kernels.ops`` picks (``q_rows``; ``q_rows_tuned``: a
    winner of the tuner made it, else ``plan_q_rows``).  ``main`` cases
    and the split route's also time the FMA variant (``fma_ms``) and hold
    its output against the plain version at its own 32-key tiles
    (``fma_max_abs_err``, the case's tolerance); the split route's bound
    counts each kept piece pair as one pass at the bf16 tensor-core rate
    (``split_passes``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flash_attention import (
        FMA_BLOCK_K, flash_attention_cuda, flash_attention_fma, flash_route,
        kernel_block_k, plan_q_rows, split_pieces_of)
    b, (hkv, g) = len(rows), heads
    h = hkv * g
    dv = d if dv is None else dv
    if page and dv != d:
        raise ValueError(f"{name}: a paged case has one head dim")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kv_lens = [q_offset + r for r in rows]
    if policy is None:
        policy = pool_policy(dtype)
    src_dt, src_fmt = kops.policy_src(policy)
    q_dt = torch.float32 if src_dt == torch.float32 else torch.bfloat16
    q = (torch.randn((b, h, chunk, d), generator=gen, device="cuda")
         * q_scale).to(q_dt)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    if page:
        max_pages = pages or -(-(q_offset + chunk) // page)
        k, v, table = _pool_and_table(gen, b, hkv, max_pages, page, d, dtype,
                                      alias)
    else:
        k = torch.randn((b, hkv, keys or chunk, d), generator=gen,
                        device="cuda").to(dtype)
        v = torch.randn((b, hkv, keys or chunk, dv), generator=gen,
                        device="cuda").to(dtype)
        table = None
    bk = kernel_block_k(src_dt, src_fmt, d, dv)
    variant = flash_route(src_dt, src_fmt, d, dv)
    call = lambda backend, cap=softcap, rows=None, blk=bk: \
        kops.flash_attention(q, k, v, kv_len=kvl, block_table=table,
                             policy=policy, causal=causal, window=window,
                             softcap=cap, q_offset=q_offset, backend=backend,
                             block_k=blk, q_rows=rows)
    by_rows = flash_attention_cuda.launches_by_q_rows
    before = (flash_variant_counts(), flash_attention_cuda.launches_noncausal,
              dict(by_rows))
    got = call("kernel")
    routed = {v: n - before[0][v] for v, n in flash_variant_counts().items()}
    ran = [r for r, n in by_rows.items() if n != before[2].get(r, 0)]
    if flash_attention_cuda.launches_noncausal - before[1] != int(not causal):
        raise AssertionError(f"{name}: the non-causal counter did not count "
                             f"the launch as {'causal' if causal else 'not'}")
    want = call("plain")
    torch.cuda.synchronize()
    if routed != {v: int(v == variant) for v in routed}:
        raise AssertionError(f"{name}: launches by variant {routed}, "
                             f"expected the {variant} variant")
    q_rows, tuned = kops.flash_q_rows(chunk, b * hkv, g, d, dv, dtype,
                                      "cuda", with_source=True)
    if ran != ([q_rows] if variant == "tc" else []):
        raise AssertionError(f"{name}: flash_tc counted under query tiles "
                             f"{ran}, kernels.ops picks {q_rows}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs().max().item()
    cap = _cap_effect(call, got) if q_scale != 1.0 else None
    # live (query, key) pairs and distinct keys read, from this run's masks:
    # the chunk's first query sees the window's first key
    qpos = q_offset + torch.arange(chunk, device="cuda")[None, :]
    hi = (torch.minimum(kvl[:, None].long(), qpos + 1) if causal
          else kvl[:, None].long().expand(b, chunk))
    lo = (torch.zeros_like(qpos) if window is None
          else torch.clamp(qpos - window + 1, min=0))
    pairs = torch.clamp(hi - lo, min=0).sum().item() * h
    skv = table.shape[1] * page if page else k.shape[2]
    keys = _keys_read(table, page, skv, lo[:, 0].expand(b), kvl)
    esz = k.element_size()
    nbytes = (q.numel() * q.element_size() + keys * hkv * (d + dv) * esz
              + got.numel() * 4 + kvl.numel() * 4)
    flops = 2.0 * (d + dv) * pairs
    if variant == "split":
        pqk, ppv = split_pieces_of(src_dt, src_fmt)
        flops = 2.0 * pairs * (d * split_passes(pqk)
                               + dv * split_passes(ppv, top=1))
    bound_ms, bound_by = bound(nbytes, flops,
                               F32_FLOP_S if variant == "fma" else BF16_FLOP_S)
    tol = F32_TOL if src_dt == torch.float32 and not src_fmt else KERNEL_TOL
    lib = None
    if (softcap is None and window is None and table is None
            and q_offset == 0 and min(rows) == k.shape[2]):
        # f32 q, k and v: SDPA in f32 (TF32 stays off in the port)
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))
    elif softcap is None and q_dt != torch.float32:
        lib = device_ms(_sdpa_chunk(q, k, v, table, kvl, q_offset, window,
                                    causal))
    args, kw = _flat_flash(q, k, v, kvl, table, policy)
    kw.update(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    kw["q_rows"] = q_rows
    extra = flash_telemetry(name, args, kw, variant)
    if variant == "tc":
        static = plan_q_rows(chunk, b * hkv, g)
        extra.update(q_rows=q_rows, q_rows_tuned=tuned, q_rows_rule=static)
        if static != q_rows:
            extra["rule_ms"] = device_ms(lambda: call("kernel", rows=static))
    if main or variant == "split":
        kw.pop("q_rows")
        fwant = call("plain", blk=FMA_BLOCK_K)
        fgot = flash_attention_fma(*args, **kw).reshape(fwant.shape)
        extra["fma_max_abs_err"] = (fgot - fwant).abs().max().item()
        extra["fma_ms"] = device_ms(lambda: flash_attention_fma(*args, **kw),
                                    3, 1)
    rec = dict(case=name, kernel="flash_attention", variant=variant,
               block_k=bk, max_abs_err=err,
               tol=tol, q_scale=q_scale, cap_effect=cap,
               kernel_ms=device_ms(lambda: call("kernel")),
               eager_ms=cuda_ms(lambda: call("kernel"), 10), **extra,
               plain_ms=cuda_ms(lambda: call("plain"), 2, warmup=1),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
               shape=dict(rows=b, heads=h, hkv=hkv, d=d, dv=dv, chunk=chunk,
                          keys=k.shape[2] if not page else None,
                          causal=causal,
                          q_offset=q_offset, page=page, kv_len=kv_lens,
                          window=window, softcap=softcap, policy=policy,
                          pool=str(dtype).replace("torch.", "")))
    if "fma_ms" in rec:
        rec["speedup_vs_fma"] = rec["fma_ms"] / rec["kernel_ms"]
    log(json.dumps(rec))
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    if not rec.get("fma_max_abs_err", 0.0) <= tol:
        raise AssertionError(f"{name}: flash_fma is off its plain version "
                             f"by {rec['fma_max_abs_err']} > {tol}")
    if cap is not None and not cap >= CAP_EFFECT_MIN:
        raise AssertionError(f"{name}: the softcap changes the output by "
                             f"{cap} < {CAP_EFFECT_MIN}")
    return rec


def decode_phase() -> list:
    """The decode cases; the first is at the serving path's shapes (the
    tuner times every cluster size: ``autotune_phase``,
    ``scripts/pretune.py``)."""
    import torch
    bf16, fp8 = torch.bfloat16, torch.float8_e5m2
    d = []
    # the slice's decode: 4 slots, a local layer (window 4096, softcap 50),
    # one idle slot, one row past the window, aliased prefix pages
    d.append(decode_case("decode_bf16_p64_local", dtype=bf16, page=64,
                         kv_lens=[1056, 540, 0, 4111], window=4096,
                         softcap=50.0, alias=4, seed=1))
    # q x 24: scores near +-80, in the softcap's bend
    d.append(decode_case("decode_fp8_p16_window", dtype=fp8, page=16,
                         kv_lens=[300, 17, 0, 1000], window=64,
                         softcap=50.0, alias=2, seed=2, q_scale=24.0))
    d.append(decode_case("decode_bf16_p64_global_nocap", dtype=bf16, page=64,
                         kv_lens=[1056, 540, 128, 4111], window=None,
                         softcap=None, alias=0, seed=3))
    # gemma2-9b's single-stream decode on a global layer at full context:
    # 8 rows, the latency case a one-CTA-per-row grid leaves 124 SMs idle
    d.append(decode_case("decode_bf16_p64_b1_global", dtype=bf16, page=64,
                         kv_lens=[8191], window=None, softcap=50.0, alias=0,
                         seed=8))
    # 16 slots on a local layer near the window: 128 rows, where the
    # static rule drops to 4 CTAs a row
    d.append(decode_case("decode_bf16_p64_b16_local", dtype=bf16, page=64,
                         kv_lens=[4111 - 97 * i for i in range(16)],
                         window=4096, softcap=50.0, alias=4, seed=9))
    # generate_phase's last decode step: its four ragged rows over the
    # 17-page tables of a 1024-token width plus 32 tokens
    d.append(decode_case("decode_bf16_p64_generate", dtype=bf16, page=64,
                         kv_lens=[p + GEN_LEN - 1 for p in GEN_PROMPTS],
                         window=4096, softcap=50.0, alias=0, seed=10))
    # the slice's local layer on the escalation phase's f32 pool (policy
    # fp32): the fma route
    d.append(decode_case("decode_f32_p64_local", dtype=torch.float32,
                         page=64, kv_lens=[1056, 540, 0, 4111], window=4096,
                         softcap=50.0, alias=4, seed=12))
    return d


def kernel_phase() -> dict:
    """Every case; returns {kernel name: [records]} (the first record of
    each kernel is the one at the serving path's shapes)."""
    import torch
    bf16, fp8 = torch.bfloat16, torch.float8_e5m2
    recs = {"decode_attention": decode_phase() + [verify_case()],
            "flash_attention": []}
    f = recs["flash_attention"]
    # the slice's prefill: a 256-token chunk continuing two prompts
    f.append(flash_case("flash_bf16_p64_chunk", dtype=bf16, page=64,
                        rows=[256, 200], q_offset=768, chunk=256,
                        window=4096, softcap=50.0, alias=4, seed=4,
                        main=True))
    f.append(flash_case("flash_fp8_p16_window", dtype=fp8, page=16,
                        rows=[256, 31], q_offset=320, chunk=256, window=200,
                        softcap=50.0, alias=3, seed=5, q_scale=24.0))
    f.append(flash_case("flash_bf16_contig_nocap", dtype=bf16, page=0,
                        rows=[1024, 1024], q_offset=0, chunk=1024,
                        window=None, softcap=None, alias=0, seed=6,
                        main=True))
    # the split route, held against its plain version (policy fp32: f32
    # operands without a grid)
    f.append(flash_case("flash_f32_fp32_small", dtype=torch.float32, page=16,
                        rows=[96, 40], q_offset=32, chunk=96, window=48,
                        softcap=50.0, alias=2, seed=7, policy="fp32",
                        heads=(2, 2), d=128))
    # generate_phase's prefill: the right-padded ragged batch in one
    # 1024-query chunk from position 0, rows far shorter than the chunk
    f.append(flash_case("flash_bf16_p64_generate", dtype=bf16, page=64,
                        rows=list(GEN_PROMPTS), q_offset=0,
                        chunk=max(GEN_PROMPTS), window=4096, softcap=50.0,
                        alias=0, seed=11,
                        pages=-(-(max(GEN_PROMPTS) + GEN_LEN) // 64)))
    # the slice's chunk on the escalation phase's f32 pool: the split
    # route, flash_fma timed beside it
    f.append(flash_case("flash_f32_p64_chunk", dtype=torch.float32, page=64,
                        rows=[256, 200], q_offset=768, chunk=256,
                        window=4096, softcap=50.0, alias=4, seed=13))
    # the 2 x 1024 causal prompt without softcap on f32 K/V: SDPA in f32
    # beside the split route
    f.append(flash_case("flash_f32_contig_nocap", dtype=torch.float32,
                        page=0, rows=[1024, 1024], q_offset=0, chunk=1024,
                        window=None, softcap=None, alias=0, seed=6,
                        policy="fp32"))
    # the chunk again through 8192-key block tables (a long-context
    # engine's): the split route stages only the keys a query sees, so the
    # wide table must cost no more than the narrow one
    f.append(flash_case("flash_f32_p64_wide_table", dtype=torch.float32,
                        page=64, rows=[256, 200], q_offset=768, chunk=256,
                        window=4096, softcap=50.0, alias=4, seed=13,
                        pages=128))
    narrow = next(c for c in f if c["case"] == "flash_f32_p64_chunk")
    if not f[-1]["kernel_ms"] <= WIDE_TABLE_RATIO * narrow["kernel_ms"]:
        raise AssertionError(
            f"flash_f32_p64_wide_table: {f[-1]['kernel_ms']} ms through an "
            f"8192-key table, {narrow['kernel_ms']} ms through the chunk's "
            f"own (more than {WIDE_TABLE_RATIO}x)")
    # flash_fma, the route of every (D, Dv) outside TC_HEAD_PAIRS (the
    # card tests' reduced escalation model has D 16), on an f32 pool with
    # a window and softcap
    f.append(flash_case("flash_f32_fma_d32", dtype=torch.float32, page=16,
                        rows=[96, 40], q_offset=32, chunk=96, window=48,
                        softcap=50.0, alias=2, seed=20, policy="fp32",
                        heads=(2, 2), d=32))
    if f[-1]["variant"] != "fma":
        raise AssertionError(f"flash_f32_fma_d32 ran on {f[-1]['variant']}")
    f.extend(mla_kernel_cases())
    for cases in (moe_kernel_cases, granite_kernel_cases, arch_kernel_cases):
        dec, fl = cases()
        recs["decode_attention"].extend(dec)
        f.extend(fl)
    return recs


def moe_kernel_cases() -> tuple:
    """The MoE phases' attention reads at their serving shapes, as
    ``(decode records, flash records)``: qwen3-moe's decode (4 slots, 32
    query and 4 KV heads of 128, so group 8, the decode kernel's kMaxG;
    pages of 64, ragged kv_len up to 4112 with an idle row, no window, no
    softcap) on a bf16 and an fp8-e5m2 pool; its 256-token prefill chunk
    at q_offset 768; and deepseek-v2-lite's expanded MLA prefill (4 rows x
    16 heads x 1024 causal, QK head dim 192, V head dim 128) on
    ``flash_tc``, with ``flash_fma`` timed beside it (``fma_ms``).  None
    has a softcap, so SDPA computes each (``library_ms``)."""
    import torch
    q3 = dict(page=64, kv_lens=[1056, 540, 0, 4112], window=None,
              softcap=None, alias=4, heads=(4, 8), d=128)
    dec = [decode_case("decode_bf16_p64_qwen3", dtype=torch.bfloat16,
                       seed=16, **q3),
           decode_case("decode_fp8_p64_qwen3", dtype=torch.float8_e5m2,
                       seed=17, **q3)]
    fl = [flash_case("flash_bf16_p64_qwen3_chunk", dtype=torch.bfloat16,
                     page=64, rows=[256, 200], q_offset=768, chunk=256,
                     window=None, softcap=None, alias=4, seed=18,
                     heads=(4, 8), d=128, main=True),
          flash_case("flash_mla_bf16_192", dtype=torch.bfloat16, page=0,
                     rows=[1024] * 4, q_offset=0, chunk=1024, window=None,
                     softcap=None, alias=0, seed=19, heads=(16, 1), d=192,
                     dv=128, main=True)]
    return dec, fl


def granite_kernel_cases() -> tuple:
    """The granite phase's attention reads at its serving shapes, as
    ``(decode records, flash records)``: granite-20b's decode (4 slots, 48
    query heads on one KV head of 128, so group 48: six head tiles of the
    kernel; pages of 64, ragged kv_len up to 4112 with an idle row, no
    window, no softcap) on a bf16 pool (route ``mma``), an fp8-e5m2 pool
    (``tp_bf16_kv8``) and an f32 pool (policy ``fp32``: route ``fma``);
    its 256-token prefill chunk at q_offset 768 on ``flash_tc`` (one KV
    head, group 48, at the query tile ``kernels.ops`` picks; the tuner
    times both).
    Each runs its telemetry instantiation (bitwise the flags-off output);
    none has a softcap, so SDPA computes each (``library_ms``)."""
    import torch
    gr = dict(page=64, kv_lens=[1056, 540, 0, 4112], window=None,
              softcap=None, alias=4, heads=(1, 48), d=128)
    dec = [decode_case("decode_bf16_p64_granite", dtype=torch.bfloat16,
                       seed=20, **gr),
           decode_case("decode_fp8_p64_granite", dtype=torch.float8_e5m2,
                       seed=21, **gr),
           decode_case("decode_f32_p64_granite", dtype=torch.float32,
                       seed=22, **gr)]
    fl = [flash_case("flash_bf16_p64_granite_chunk", dtype=torch.bfloat16,
                     page=64, rows=[256, 200], q_offset=768, chunk=256,
                     window=None, softcap=None, alias=4, seed=23,
                     heads=(1, 48), d=128, main=True)]
    return dec, fl


def mla_kernel_cases() -> list:
    """The MLA phase's prefill read (minicpm3-4b's expanded form: 4 rows x
    40 heads, QK head dim 96, V head dim 64, no softcap, contiguous): its
    ragged batch, and a uniform one at 1024, which SDPA also computes."""
    import torch
    mla = dict(dtype=torch.bfloat16, page=0, q_offset=0, chunk=1024,
               window=None, softcap=None, alias=0, heads=(40, 1), d=96,
               dv=64)
    return [flash_case("flash_mla_bf16_ragged", rows=list(MLA_PROMPTS),
                       seed=14, **mla),
            flash_case("flash_mla_bf16_uniform", rows=[1024] * 4, seed=15,
                       main=True, **mla)]


def _plant(pool, table, row, pos, value):
    """Write ``value`` into every KV head's element 0 of token ``pos`` of
    batch row ``row`` (through ``table``) of a pool [n_pages, Hkv, page, D]."""
    page = pool.shape[2]
    pool[int(table[row, pos // page]), :, pos % page, 0] = value


def telemetry_phase() -> list:
    """The telemetry instantiations on damaged pools, one case per
    variant: decode ``mma`` and ``flash_tc`` (TMA) on a native bf16 pool
    with +-Inf and NaN in live keys, in dead slots of a live page, in a
    row of length 0 and left of the window; decode ``fma`` and
    ``flash_tc`` (converting f32 containers) on an ``em_fp8`` pool with
    ``kv_fmt`` fp8 holding values beyond fp8's max and below its min
    normal, with a window.  (The split route is held on the f32-pool
    cases of the kernel phase.)  Each: the output bitwise the flags-off one,
    visits and flags exactly the plain version's, the route named."""
    import torch
    from repro_torch.core.formats import get_format
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.decode_attention import decode_route
    from repro_torch.kernels.flash_attention import flash_route
    bf16, f32 = torch.bfloat16, torch.float32
    hkv, g, d = 8, 2, 256
    out = []
    em = get_policy("em_fp8").replace(kv_fmt=get_format("fp8"))
    for name, dtype, policy, page, lens, window in (
            ("telemetry_bf16_p64_damaged", bf16, get_policy("tp_bf16"), 64,
             [1056, 540, 0, 4111], 4096),
            ("telemetry_em_fp8_p16_window", f32, em, 16, [300, 17, 0, 1000],
             64)):
        gen = torch.Generator(device="cuda").manual_seed(21)
        b = len(lens)
        max_pages = -(-(max(lens) + 1) // page)
        k, v, table = _pool_and_table(gen, b, hkv, max_pages, page, d,
                                      f32, 2)
        if dtype == f32:      # magnitudes from 10^-7 to 10^6
            mag = lambda x: x * 10.0 ** (13 * torch.rand(
                x.shape, generator=gen, device="cuda") - 7)
            k, v = mag(k), mag(v)
        k, v = k.to(dtype), v.to(dtype)
        for r, n in enumerate(lens):
            if n:
                _plant(k, table, r, n // 2, float("inf"))       # live
                _plant(v, table, r, n - 1, float("nan"))
                if n + 1 < max_pages * page:
                    _plant(k, table, r, n + 1, float("-inf"))      # dead
        _plant(v, table, 2, 3, float("nan"))        # the row of length 0
        _plant(k, table, 3, 5, float("inf"))        # left of the window
        kvl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        src_dt, grid = kops.policy_src(policy)
        kv_fmt = (policy.kv_fmt.name if policy.mode != "native"
                  and policy.kv_fmt is not None else None)
        q = torch.randn((b, hkv * g, 1, d), generator=gen, device="cuda")
        q = q.to(f32 if src_dt == f32 else bf16)
        flat = lambda x: x.reshape(-1, page, d)
        args = (q.reshape(b * hkv, g, d), flat(k), flat(v),
                kops.expand_kv_lens(kvl, b, hkv, max_pages * page, "cuda"),
                kops.expand_block_table(table, hkv))
        kw = dict(scale=d ** -0.5, window=window, softcap=50.0,
                  kv_fmt_name=kv_fmt, q_fmt_name=grid, src_dtype=src_dt)
        variant = decode_route(src_dt, d)
        rec = dict(case=name.replace("telemetry", "decode"),
                   kernel="decode_attention", variant=variant,
                   **decode_telemetry(name, args, kw, variant))
        log(json.dumps(rec))
        out.append(rec)
        # a 256-token prefill chunk at q_offset 256 through the same pool
        chunk, off = 256, 256
        rows = [min(chunk, max(0, n - off)) for n in lens]
        qf = torch.randn((b * hkv * g, chunk, d), generator=gen,
                         device="cuda").to(q.dtype)
        fargs = (qf, flat(k), flat(v),
                 kops.expand_kv_lens(torch.tensor(
                     [off + r for r in rows], dtype=torch.int32,
                     device="cuda"), b, hkv * g, max_pages * page, "cuda"),
                 kops.expand_block_table(table, hkv))
        fkw = dict(group=g, scale=d ** -0.5, causal=True, window=window,
                   softcap=50.0, q_offset=off, src_fmt_name=grid,
                   src_dtype=src_dt)
        fvar = flash_route(src_dt, grid, d)
        rec = dict(case=name.replace("telemetry", "flash"),
                   kernel="flash_attention", variant=fvar,
                   **flash_telemetry(name, fargs, fkw, fvar))
        log(json.dumps(rec))
        out.append(rec)
    if sorted((r["kernel"], r["variant"]) for r in out) != [
            ("decode_attention", "fma"), ("decode_attention", "mma"),
            ("flash_attention", "tc"), ("flash_attention", "tc")]:
        raise AssertionError(f"telemetry cases ran on {out}")
    return out


def _same_class(name, got, want, tol) -> float:
    """Raise unless ``got`` is NaN where ``want`` is, the same signed Inf
    where it is Inf, and within ``tol`` (a number or a tensor) of it
    elsewhere; returns the largest error over the finite outputs."""
    import torch
    got, want = got.float(), want.float()
    inf = torch.isinf(want)
    fin = torch.isfinite(want)
    if not (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.isinf(got), inf)
            and torch.equal(got[inf], want[inf])):
        raise AssertionError(
            f"{name}: non-finite outputs differ from the plain version's "
            f"(NaN {int(torch.isnan(got).sum())} vs "
            f"{int(torch.isnan(want).sum())}, Inf {int(torch.isinf(got).sum())}"
            f" vs {int(inf.sum())})")
    err = (got[fin] - want[fin]).abs()
    tol = tol[fin] if torch.is_tensor(tol) else tol
    if not (err <= tol).all():
        raise AssertionError(f"{name}: finite outputs beyond the tolerance")
    return err.max().item() if err.numel() else 0.0


def nonfinite_phase() -> list:
    """The split routes on operands holding +-Inf and NaN, their values
    held against the plain version: NaN where it gives NaN, the same
    signed Inf where it gives Inf, the finite outputs within the route's
    tolerance.  Flash on a gemma2-9b-wide f32 pool (policy fp32) with Inf
    in one element of K and of V at live keys, without and with softcap
    (which caps a K Inf's score); tp_matmul, f32 without a grid (a split
    K) and on the tf32 grid, with an Inf meeting a bf16-exact partner
    (whose lower pieces are 0), Inf x Inf at one index, Inf x 0 and a
    NaN."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     kernel_block_k)
    from repro_torch.kernels.tp_matmul import (agreement_tol, plan_split,
                                               tp_matmul_cuda,
                                               tp_matmul_plain)
    out = []
    hkv, g, d, page, chunk, off = 8, 2, 256, 64, 128, 64
    rows = [128, 100]
    for softcap in (None, 50.0):
        gen = torch.Generator(device="cuda").manual_seed(22)
        b = len(rows)
        k, v, table = _pool_and_table(gen, b, hkv, -(-(off + chunk) // page),
                                      page, d, torch.float32, 0)
        k[int(table[0, 70 // page]), 3, 70 % page, 5] = float("inf")
        v[int(table[0, 40 // page]), 1, 40 % page, 7] = float("inf")
        v[int(table[1, 90 // page]), 6, 90 % page, 9] = -float("inf")
        q = torch.randn((b, hkv * g, chunk, d), generator=gen, device="cuda")
        kvl = torch.tensor([off + r for r in rows], dtype=torch.int32,
                           device="cuda")
        call = lambda backend: kops.flash_attention(
            q, k, v, kv_len=kvl, block_table=table, policy="fp32",
            window=None, softcap=softcap, q_offset=off, backend=backend,
            block_k=kernel_block_k(torch.float32, None, d))
        before = flash_attention_cuda.launches_split
        got = call("kernel")
        if flash_attention_cuda.launches_split != before + 1:
            raise AssertionError("nonfinite flash: not on the split route")
        want = call("plain")
        name = f"nonfinite_flash_f32_{'cap' if softcap else 'nocap'}"
        rec = dict(case=name, kernel="flash_attention", variant="split",
                   nan=int(torch.isnan(want).sum()),
                   inf=int(torch.isinf(want).sum()),
                   max_abs_err=_same_class(name, got, want, F32_TOL),
                   tol=F32_TOL)
        if not rec["inf"]:
            raise AssertionError(f"{name}: the plain version has no Inf")
        log(json.dumps(rec))
        out.append(rec)
    for name, (m, kk, n), quant in (
            ("nonfinite_mm_f32_split_k", (64, 3584, 256), None),
            ("nonfinite_mm_tf32", (96, 640, 200), "tf32")):
        gen = torch.Generator(device="cuda").manual_seed(23)
        a = torch.randn((m, kk), generator=gen, device="cuda")
        bm = torch.randn((kk, n), generator=gen, device="cuda") * kk ** -0.5
        a[0, 3], bm[3, 1] = float("inf"), 0.5
        bm[3, 2] = -float("inf")
        a[1, 4], bm[4, 9] = -float("inf"), 0.0
        a[2, 5], a[2, 6], bm[5, 11], bm[6, 11] = (float("inf"),) * 2 + (
            1.0, -1.0)
        a[3, 0] = float("nan")
        bm[kk - 1, n - 1] = float("inf")
        before = tp_matmul_cuda.launches_split
        plan = plan_split(m, kk, n)
        got = tp_matmul_cuda(a, bm, quant_fmt_name=quant, plan=plan)
        if tp_matmul_cuda.launches_split != before + 1:
            raise AssertionError(f"{name}: not on the split route")
        want = tp_matmul_plain(a, bm, quant_fmt_name=quant, plan=plan)
        rec = dict(case=name, kernel="tp_matmul", variant="split",
                   splits=plan.splits, nan=int(torch.isnan(want).sum()),
                   inf=int(torch.isinf(want).sum()),
                   max_abs_err=_same_class(
                       name, got, want,
                       agreement_tol(a, bm, got, want, quant)))
        if not (rec["inf"] and rec["nan"]):
            raise AssertionError(f"{name}: the plain version lacks Inf or "
                                 f"NaN")
        log(json.dumps(rec))
        out.append(rec)
    if plan_split(64, 3584, 256).splits < 2:
        raise AssertionError("nonfinite_mm_f32_split_k: K is not split")
    return out


# ---------------------------------------------------------------------------
# phase 3: the transprecision op path at gemma2-9b's MLP widths
# ---------------------------------------------------------------------------
D_MODEL, D_FF = 3584, 14336
#: integer operations of the CONV snap per element (``quantize_bits``:
#: mask, shift, add, compare and select steps), counted at the f32 rate
SNAP_OPS = 12
#: dotp_ex: each of kernel and plain within this share of sum |a_i b_i| of
#: the exact f64 sum (f32 sums of 51M exact products in two orders)
DOTP_REL_TOL = 1e-5
#: Table III (paper): the expanding FMA keeps >= 22 correct bits (variant e)
TABLE3_MIN_BITS = 22


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _bit_mismatches(got, want) -> int:
    """Elements whose bits differ, NaN-aware (a NaN only has to be NaN)
    and sign-of-zero aware."""
    import torch
    idt = {4: torch.int32, 2: torch.int16}[got.element_size()]
    nan_g, nan_w = torch.isnan(got.float()), torch.isnan(want.float())
    diff = (got.view(idt) != want.view(idt)) & ~(nan_g & nan_w)
    return int((diff | (nan_g != nan_w)).sum().item())


def _edges(x):
    """Put the snap's edge cases into the first row of ``x``: both zeros,
    Inf, NaN, an f32 subnormal, values at and under fp8 min normal, fp8 max
    normal and its overflow tie."""
    import torch
    e = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                      1e-40, 2.0 ** -14, 2.0 ** -14 * (1 - 2.0 ** -3),
                      2.0 ** -15, 57344.0, 61440.0, -61440.0],
                     device=x.device)
    x[0, :e.numel()] = e
    return x


def _snap_readback(a, b, quant):
    """The kernel's snapped operands, read back through identity products
    (x * 1 plus zeros is exact) in K chunks of 2048, against the plain
    snap.  Values are compared: an f32 sum starting at +0 turns a snapped
    -0 into +0.  Returns the number of differing elements."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.tp_matmul import tp_matmul_cuda
    k, c = a.shape[1], 2048
    bad = 0
    for k0 in range(0, k, c):
        eye = torch.eye(min(c, k - k0), device="cuda")
        sa = tp_matmul_cuda(a[:, k0:k0 + c].contiguous(), eye,
                            quant_fmt_name=quant)
        sb = tp_matmul_cuda(eye, b[k0:k0 + c], quant_fmt_name=quant)
        bad += int((sa != ref.tp_quantize_ref(a[:, k0:k0 + c],
                                              fmt_name=quant)).sum().item())
        bad += int((sb != ref.tp_quantize_ref(b[k0:k0 + c],
                                              fmt_name=quant)).sum().item())
    return bad


def mm_case(name, *, m, k, n, dtype, out_dtype, quant=None, seed,
            flop_s=BF16_FLOP_S, library=True, library_note=None, iters=20,
            main=False):
    """One tp_matmul case: ``a [m, k] @ b [k, n]`` (b scaled by k^-1/2,
    a weight's scale) in ``dtype``, stored in ``out_dtype``, the
    tensor-core variant or the split route at the plan ``kernels.ops``
    picks (``plan_tuned``: a winner of the tuner made it, else
    ``plan_tc`` / ``plan_split``); the plain version walks the same K
    ranges.  ``main`` cases and the split route's also time the FMA
    variant (``fma_ms``) and hold its output against the plain version
    within ``agreement_tol`` (``fma_max_err_over_tol``); the split
    route's bound counts each kept piece pair as one pass at the bf16
    rate."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.quant_common import split_pieces
    from repro_torch.kernels.tp_matmul import (agreement_tol, matmul_route,
                                               plan_split, plan_tc,
                                               tp_matmul_cuda, tp_matmul_fma,
                                               tp_matmul_plain)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    b = (torch.randn((k, n), generator=gen, device="cuda")
         * k ** -0.5).to(dtype)
    variant = matmul_route(dtype, quant)
    plan, tuned = kops.tp_matmul_plan(m, k, n, dtype, "cuda", quant,
                                      with_source=True)
    plan = plan if variant != "fma" else None
    kern = lambda: tp_matmul_cuda(a, b, out_dtype=out_dtype,
                                  quant_fmt_name=quant, plan=plan)
    plain = lambda: tp_matmul_plain(a, b, out_dtype=out_dtype,
                                    quant_fmt_name=quant, plan=plan)
    by_plan = tp_matmul_cuda.launches_by_plan
    before = (matmul_variant_counts(), dict(by_plan))
    got = kern()
    routed = {v: c - before[0][v] for v, c in matmul_variant_counts().items()}
    ran = [p for p, c in by_plan.items() if c != before[1].get(p, 0)]
    want = plain()
    torch.cuda.synchronize()
    if routed != {v: int(v == variant) for v in routed}:
        raise AssertionError(f"{name}: launches by variant {routed}, "
                             f"expected the {variant} variant")
    if ran != ([(plan.wm, plan.splits)] if plan else []):
        raise AssertionError(f"{name}: tp_matmul_{variant} counted under "
                             f"plans {ran}, kernels.ops picks {plan}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got.float() - want.float()).abs()
    tol = agreement_tol(a, b, got, want, quant)
    over = int((err > tol).sum().item())
    snap_bad = _snap_readback(a, b, quant) if quant else None
    flops = 2.0 * m * k * n
    if variant == "split":
        flops *= split_passes(split_pieces(dtype, quant))
    bound_ms, bound_by = bound(_nbytes(a, b, got), flops, flop_s)
    if library and dtype == torch.float32:
        # torch.mm in full f32, the kernel's function (TF32 off in the port)
        assert not torch.backends.cuda.matmul.allow_tf32
    lib = device_ms(lambda: torch.mm(a, b)) if library else None
    extra = {}
    static = ((plan_split if variant == "split" else plan_tc)(m, k, n)
              if plan else None)
    if static is not None and static != plan:
        extra["rule_ms"] = device_ms(lambda: tp_matmul_cuda(
            a, b, out_dtype=out_dtype, quant_fmt_name=quant, plan=static))
    if main or variant == "split":
        fgot = tp_matmul_fma(a, b, out_dtype=out_dtype, quant_fmt_name=quant)
        ferr = (fgot.float() - want.float()).abs()
        ftol = agreement_tol(a, b, fgot, want, quant)
        extra["fma_elements_over_tol"] = int((ferr > ftol).sum().item())
        extra["fma_max_err_over_tol"] = (ferr / ftol).max().item()
        extra["fma_ms"] = device_ms(lambda: tp_matmul_fma(
            a, b, out_dtype=out_dtype, quant_fmt_name=quant), 3, 1)
    rec = dict(case=name, kernel="tp_matmul", variant=variant,
               plan=dataclasses.asdict(plan) if plan else None,
               plan_tuned=tuned if plan else None,
               plan_rule=dataclasses.asdict(static) if plan else None,
               max_abs_err=err.max().item(),
               elements_over_tol=over,
               max_err_over_tol=(err / tol).max().item(),
               snap_mismatches=snap_bad,
               kernel_ms=device_ms(kern), eager_ms=cuda_ms(kern, iters),
               **extra,
               plain_ms=cuda_ms(plain, 5, warmup=1),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
               library_note=library_note,
               shape=dict(m=m, k=k, n=n, operands=str(dtype)[6:],
                          out=str(out_dtype)[6:], quant=quant))
    if "fma_ms" in rec:
        rec["speedup_vs_fma"] = rec["fma_ms"] / rec["kernel_ms"]
    log(json.dumps(rec))
    if over:
        raise AssertionError(f"{name}: {over} elements beyond the tolerance")
    if extra.get("fma_elements_over_tol"):
        raise AssertionError(f"{name}: tp_matmul_fma has "
                             f"{extra['fma_elements_over_tol']} elements "
                             f"beyond agreement_tol")
    if snap_bad:
        raise AssertionError(f"{name}: {snap_bad} snapped operands differ")
    return rec


def quant_case(name, *, rows, cols, fmt, stochastic, out_dtype, seed,
               pack=False):
    """One tp_quantize (or, with ``pack``, cast_and_pack) case on f32
    weights of scale cols^-1/2 with the edge cases in their first row."""
    import torch
    from repro_torch.kernels.tp_quant import (cast_and_pack_cuda,
                                              cast_and_pack_plain,
                                              tp_quantize_cuda,
                                              tp_quantize_plain)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda: _edges(torch.randn((rows, cols), generator=gen,
                                    device="cuda") * cols ** -0.5)
    x = mk()
    y = mk() if pack else None
    rbits = (torch.randint(-(1 << 31), 1 << 31, (rows, cols),
                           dtype=torch.int32, generator=gen, device="cuda")
             if stochastic else None)
    kw = dict(fmt_name=fmt, stochastic=stochastic, out_dtype=out_dtype)
    if pack:
        kern = lambda: cast_and_pack_cuda(x, y, rbits, **kw)
        plain = lambda: cast_and_pack_plain(x, y, rbits, **kw)
        ins = (x, y) + ((rbits,) if stochastic else ())
    else:
        kern = lambda: tp_quantize_cuda(x, rbits, **kw)
        plain = lambda: tp_quantize_plain(x, rbits, **kw)
        ins = (x,) + ((rbits,) if stochastic else ())
    got, want = kern(), plain()
    torch.cuda.synchronize()
    bad = _bit_mismatches(got, want)
    live = ~torch.isnan(want.float())
    err = (got.float() - want.float())[live].abs()
    err = err[torch.isfinite(err)].max().item()
    n_el = x.numel() * (2 if pack else 1)
    bound_ms, bound_by = bound(_nbytes(*ins, got), SNAP_OPS * n_el,
                               F32_FLOP_S)
    rec = dict(case=name, kernel="cast_and_pack" if pack else "tp_quantize",
               max_abs_err=err, bit_mismatches=bad,
               kernel_ms=device_ms(kern), eager_ms=cuda_ms(kern, 20),
               plain_ms=cuda_ms(plain, 5, warmup=1),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               library_note="no one torch call computes the FTZ grid snap: "
                            ".to(float8_e5m2) / .to(bfloat16) keep "
                            "subnormals",
               shape=dict(rows=rows, cols=cols, fmt=fmt,
                          stochastic=stochastic, out=str(out_dtype)[6:]))
    log(json.dumps(rec))
    if bad:
        raise AssertionError(f"{name}: {bad} elements differ in their bits")
    return rec


def _dotp_check(name, a, b, lanes_k, lanes_p):
    """(kernel total, plain total, exact f64 sum, sum |a b|) on the card;
    raises when either total is off the exact sum by more than the
    tolerance."""
    import torch
    pa, pb = a.double(), b.double()
    exact = (pa * pb).sum().item()
    scale = (pa * pb).abs().sum().item()
    tk, tp = lanes_k.double().sum().item(), lanes_p.double().sum().item()
    for who, t in (("kernel", tk), ("plain", tp)):
        if not (math.isfinite(t) and abs(t - exact) <= DOTP_REL_TOL * scale):
            raise AssertionError(f"{name}: {who} sum {t} vs exact {exact} "
                                 f"(sum |ab| {scale})")
    return tk, tp, exact, scale


def dotp_case(name, *, n, seed):
    """dotp_ex over two fp16 streams of ``n`` values at a weight's scale
    (d_model^-1/2)."""
    import torch
    from repro_torch.kernels.dotp_ex import dotp_ex_cuda, dotp_ex_plain
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = (torch.randn(n, generator=gen, device="cuda") * D_MODEL ** -0.5).half()
    b = (torch.randn(n, generator=gen, device="cuda") * D_MODEL ** -0.5).half()
    kern = lambda: dotp_ex_cuda(a, b, src_dtype=torch.float16)
    plain = lambda: dotp_ex_plain(a, b, src_dtype=torch.float16)
    tk, tp, exact, scale = _dotp_check(name, a, b, kern(), plain())
    bound_ms, bound_by = bound(_nbytes(a, b), 2.0 * n, F32_FLOP_S)
    rec = dict(case=name, kernel="dotp_ex", max_abs_err=abs(tk - tp),
               kernel_err_vs_exact=abs(tk - exact),
               plain_err_vs_exact=abs(tp - exact), sum_abs=scale,
               tol=DOTP_REL_TOL * scale,
               kernel_ms=device_ms(kern), eager_ms=cuda_ms(kern, 20),
               plain_ms=cuda_ms(plain, 5, warmup=1),
               bound_ms=bound_ms, bound_by=bound_by,
               library_ms=device_ms(lambda: torch.mm(
                   a.view(1, -1), b.view(-1, 1), out_dtype=torch.float32)),
               library_note="torch.mm([1, n] fp16, [n, 1] fp16, "
                            "out_dtype=float32)",
               shape=dict(n=n, dtype="float16", src="float16"))
    log(json.dumps(rec))
    return rec


def table3_case(seed: int = 0, n: int = 1024):
    """The paper's Table III stream (``benchmarks/table3_case_study.py``):
    two uniform [0, 1) streams of ``n`` values rounded to fp16; the
    expanding dot product must keep >= ``TABLE3_MIN_BITS`` correct bits
    against the exact f64 sum, in the kernel and in the plain version."""
    import numpy as np
    import torch
    from repro_torch.core import softfloat
    from repro_torch.kernels.dotp_ex import dotp_ex_cuda, dotp_ex_plain
    rs = np.random.RandomState(seed)
    a64, b64 = rs.uniform(0.0, 1.0, n), rs.uniform(0.0, 1.0, n)
    a = softfloat.quantize(torch.tensor(a64, dtype=torch.float32,
                                        device="cuda"), "fp16").half()
    b = softfloat.quantize(torch.tensor(b64, dtype=torch.float32,
                                        device="cuda"), "fp16").half()
    lk = dotp_ex_cuda(a, b, src_dtype=torch.float16)
    lp = dotp_ex_plain(a, b, src_dtype=torch.float16)
    tk, tp, exact, _ = _dotp_check("dotp_fp16_table3", a, b, lk, lp)

    def bits(res):
        rel = abs(res - exact) / abs(exact)
        return 30 if rel == 0 else max(0, math.floor(-math.log2(rel)))
    rec = dict(case="dotp_fp16_table3", kernel="dotp_ex",
               max_abs_err=abs(tk - tp), exact=exact, kernel_sum=tk,
               plain_sum=tp, kernel_bits=bits(tk), plain_bits=bits(tp),
               min_bits=TABLE3_MIN_BITS,
               kernel_ms=device_ms(lambda: dotp_ex_cuda(
                   a, b, src_dtype=torch.float16)),
               bound_ms=bound(_nbytes(a, b), 2.0 * n, F32_FLOP_S)[0],
               shape=dict(n=n, dtype="float16", src="float16"))
    log(json.dumps(rec))
    if min(rec["kernel_bits"], rec["plain_bits"]) < TABLE3_MIN_BITS:
        raise AssertionError(f"Table III stream: {rec['kernel_bits']} / "
                             f"{rec['plain_bits']} correct bits < "
                             f"{TABLE3_MIN_BITS}")
    return rec


def op_kernel_phase() -> dict:
    """Every op-path case; returns {kernel name: [records]} (the first
    record of each kernel is its main case)."""
    import torch
    # switches off reduced-precision bf16 reductions, so torch.mm computes
    # the kernel's function (one f32 sum rounded once)
    import repro_torch.core.ops  # noqa: F401
    bf16, f32 = torch.bfloat16, torch.float32
    recs = {"tp_matmul": [], "tp_quantize": [], "cast_and_pack": [],
            "dotp_ex": []}
    mm = recs["tp_matmul"]
    no_snap_lib = "no one torch call fuses the FTZ fp8 grid snap into the " \
                  "product"
    mm.append(mm_case("mm_bf16_mlp_up", m=256, k=D_MODEL, n=D_FF, dtype=bf16,
                      out_dtype=bf16, seed=11, main=True))
    mm.append(mm_case("mm_bf16_decode", m=4, k=D_MODEL, n=D_FF, dtype=bf16,
                      out_dtype=bf16, seed=12, main=True))
    mm.append(mm_case("mm_em_fp8_mlp_down", m=256, k=D_FF, n=D_MODEL,
                      dtype=f32, out_dtype=f32, quant="fp8", seed=13,
                      library=False, iters=10, library_note=no_snap_lib,
                      main=True))
    # the narrow-N product that the K split is for
    mm.append(mm_case("mm_bf16_mlp_down", m=256, k=D_FF, n=D_MODEL,
                      dtype=bf16, out_dtype=bf16, seed=16))
    mm.append(mm_case("mm_em_fp8_mlp_up", m=256, k=D_MODEL, n=D_FF,
                      dtype=f32, out_dtype=f32, quant="fp8", seed=17,
                      library=False, iters=10, library_note=no_snap_lib))
    # the split route, held against its plain version: the tf32 grid
    # (wider than 16 bits: two pieces, every kept pair exact) and f32
    # without a grid at the op path's main shape (three pieces), beside
    # torch.mm in full f32
    mm.append(mm_case("mm_tf32_grid_small", m=96, k=640, n=200, dtype=f32,
                      out_dtype=f32, quant="tf32", seed=18, library=False,
                      library_note="no one torch call fuses the tf32 grid "
                                   "snap into the product"))
    mm.append(mm_case("mm_fp32_mlp_up", m=256, k=D_MODEL, n=D_FF, dtype=f32,
                      out_dtype=f32, seed=19, iters=10))
    mm.append(mm_case("mm_fp8_native", m=256, k=D_MODEL, n=D_FF,
                      dtype=torch.float8_e5m2, out_dtype=bf16, seed=14,
                      flop_s=FP8_FLOP_S, library=False,
                      library_note="torch.mm does not take float8 operands; "
                                   "torch._scaled_mm is a private call"))
    mm.append(mm_case("mm_ragged", m=50, k=100, n=70, dtype=bf16,
                      out_dtype=bf16, seed=15))
    q = recs["tp_quantize"]
    q.append(quant_case("quant_fp8_rne_weight", rows=D_MODEL, cols=D_FF,
                        fmt="fp8", stochastic=False, out_dtype=f32, seed=21))
    q.append(quant_case("quant_fp8_stoch_weight", rows=D_MODEL, cols=D_FF,
                        fmt="fp8", stochastic=True, out_dtype=f32, seed=22))
    q.append(quant_case("quant_fp16alt_bf16out", rows=D_MODEL, cols=D_FF,
                        fmt="fp16alt", stochastic=False, out_dtype=bf16,
                        seed=23))
    recs["cast_and_pack"].append(quant_case(
        "pack_fp8_weight", rows=D_MODEL, cols=D_FF, fmt="fp8",
        stochastic=False, out_dtype=f32, seed=24, pack=True))
    recs["dotp_ex"].append(dotp_case("dotp_fp16_weight", n=D_MODEL * D_FF,
                                     seed=31))
    recs["dotp_ex"].append(table3_case())
    torch.cuda.empty_cache()
    return recs


def op_path_phase(seed: int = 0) -> dict:
    """The op path's public entry points in sequence at gemma2-9b's MLP
    widths, each through its kernel: two f32 weights [3584, 14336] quantized
    to fp8, the two em_fp8 products of x [256, 3584] with them, the two
    products packed, and the expanding dot product of the two weights as
    fp16 streams.  Every launch counter must be > 0 afterwards and every
    output finite; slices are held against the plain versions."""
    import torch
    from repro_torch.core import ops as tops
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.dotp_ex import dotp_ex_cuda
    from repro_torch.kernels.tp_matmul import (agreement_tol, tp_matmul_cuda,
                                               tp_matmul_plain)
    from repro_torch.kernels.tp_quant import (cast_and_pack_cuda,
                                              tp_quantize_cuda,
                                              tp_quantize_plain)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w1, w2 = (torch.randn((D_MODEL, D_FF), generator=gen, device="cuda")
              * D_MODEL ** -0.5 for _ in range(2))
    x = torch.randn((256, D_MODEL), generator=gen, device="cuda")
    kernels = {"tp_matmul": tp_matmul_cuda, "tp_quantize": tp_quantize_cuda,
               "cast_and_pack": cast_and_pack_cuda, "dotp_ex": dotp_ex_cuda}
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    tp_matmul_cuda.launches_tc = tp_matmul_cuda.launches_split = 0
    tp_matmul_cuda.launches_fma = 0
    tp_matmul_cuda.launches_by_plan.clear()
    kops.reset_picked()
    t0 = time.perf_counter()
    w1q = kops.tp_quantize(w1, fmt="fp8")
    w2q = kops.tp_quantize(w2, fmt="fp8")
    y1 = tops.tp_matmul(x, w1q, "em_fp8", use_kernel=True)
    y2 = tops.tp_matmul(x, w2q, "em_fp8", use_kernel=True)
    packed = kops.cast_and_pack(y1, y2, fmt="fp8")
    d = kops.dotp_ex(w1q.half().reshape(-1), w2q.half().reshape(-1),
                     policy="tp_fp16")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    variants = {"tp_matmul": matmul_variant_counts()}
    by_plan = dict(tp_matmul_cuda.launches_by_plan)
    if by_plan != kops.picked["matmul"]:
        raise AssertionError(f"op path: tp_matmul_tc launches by plan "
                             f"{by_plan}, kernels.ops picked "
                             f"{kops.picked['matmul']}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the op path")
    if variants["tp_matmul"] != {"tc": 2, "split": 0, "fma": 0}:
        raise AssertionError(f"the em_fp8 products did not both take the "
                             f"tensor-core variant: {variants}")
    outs = dict(w1q=w1q, w2q=w2q, y1=y1, y2=y2, packed=packed, d=d)
    for name, t in outs.items():
        if not torch.isfinite(t).all():
            raise AssertionError(f"op path: {name} is not finite")
    if packed.shape != (256, 2 * D_FF) or y1.shape != (256, D_FF):
        raise AssertionError(f"op path shapes {tuple(y1.shape)}, "
                             f"{tuple(packed.shape)}")
    # against the plain versions on slices of the same data
    w_bad = _bit_mismatches(w1q[:64], tp_quantize_plain(w1[:64],
                                                        fmt_name="fp8"))
    ys = tp_matmul_plain(x[:16], w1q[:, :256], quant_fmt_name="fp8")
    y_over = int(((y1[:16, :256] - ys).abs() > agreement_tol(
        x[:16], w1q[:, :256], y1[:16, :256], ys, "fp8")).sum().item())
    p_bad = _bit_mismatches(packed[:16, 1::2], tp_quantize_plain(
        y2[:16].contiguous(), fmt_name="fp8"))
    _, _, exact, scale = _dotp_check(
        "op path dotp", w1q.half().reshape(-1), w2q.half().reshape(-1),
        d.reshape(1, 1), d.reshape(1, 1))
    res = dict(wall_s=wall, launches=launches, variants=variants,
               matmul_launches_by_plan={f"{wm}x{sp}": c for (wm, sp), c
                                        in by_plan.items()},
               matmul_tuned_picks=kops.tuned["matmul"],
               weight_snap_mismatches=w_bad,
               matmul_elements_over_tol=y_over, pack_mismatches=p_bad,
               dotp=d.item(), dotp_exact=exact, dotp_sum_abs=scale,
               fp8_share_of_weight_zero=(w1q == 0).float().mean().item())
    log(json.dumps({"op_path": res}))
    if w_bad or y_over or p_bad:
        raise AssertionError(f"op path disagrees with the plain versions: "
                             f"{res}")
    del w1, w2, x, outs, w1q, w2q, y1, y2, packed
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 3b: the autotuner
# ---------------------------------------------------------------------------
#: one shape per op: the slice's local decode, its 256-token chunk, and
#: the op path's MLP down product (``autotune`` shapes; the tensors of the
#: default call that follows give the same keys)
AUTOTUNE_LEG = (("decode_bf16_p64_local", "decode_attn",
                 (32, 65, 64, 2, 256)),
                ("flash_bf16_p64_chunk", "attn", (256, 16, 2, 256, 256)),
                ("mm_bf16_mlp_down", "matmul", (256, D_FF, D_MODEL)))


def _autotune_default_call(op: str, shape) -> dict:
    """One default call through ``kernels.ops`` at ``shape`` (bf16), and
    the launches it counted by its knob: {knob: launches}."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.tp_matmul import tp_matmul_cuda
    gen = torch.Generator(device="cuda").manual_seed(40)
    bf = torch.bfloat16
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(bf)
    if op == "decode_attn":          # 4 slots x 8 KV heads, a local layer
        rows, units, page, g, d = shape
        b = rows // 8
        k, v = rnd(b * units + 1, 8, page, d), rnd(b * units + 1, 8, page, d)
        table = torch.arange(b * units, dtype=torch.int32,
                             device="cuda").reshape(b, units)
        kvl = torch.full((b,), units * page - 1, dtype=torch.int32,
                         device="cuda")
        counter = decode_attention_cuda.launches_by_cluster
        call = lambda: kops.decode_attention(
            rnd(b, 8 * g, 1, d), k, v, kv_len=kvl, block_table=table,
            window=4096, softcap=50.0)
    elif op == "attn":               # 2 rows x 8 KV heads, contiguous
        sq, bkv, g, d, _ = shape
        b = bkv // 8
        counter = flash_attention_cuda.launches_by_q_rows
        call = lambda: kops.flash_attention(
            rnd(b, 8 * g, sq, d), rnd(b, 8, sq, d), rnd(b, 8, sq, d),
            kv_len=torch.full((b,), sq, dtype=torch.int32, device="cuda"))
    else:
        m, k, n = shape
        counter = tp_matmul_cuda.launches_by_plan
        call = lambda: kops.tp_matmul(rnd(m, k), rnd(k, n) * k ** -0.5,
                                      policy="tp_bf16")
    before = dict(counter)
    with torch.no_grad():
        out = call()
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"autotune {op}: the default call is not finite")
    return {c: n - before.get(c, 0) for c, n in counter.items()
            if n != before.get(c, 0)}


def autotune_phase() -> dict:
    """The autotuner on the card: how many of the shipped winners
    (``kernels/pretuned.json``) the loader adopted for this card and
    build, so whether the serving phases run tuned; then a sweep of each
    ``AUTOTUNE_LEG`` shape through ``autotune_*`` into a temporary user
    cache (``REPRO_TORCH_AUTOTUNE_CACHE``, never the home directory), each
    candidate held to its plain version at that candidate before it is
    timed (device ms, median of 5 CUDA-graph replays).  With the winner
    recorded, one default call through ``kernels.ops`` must count its
    launch under the winner (``launches_by_cluster``,
    ``launches_by_q_rows``, ``launches_by_plan``).  The temporary cache is
    dropped at the end: the later phases run on the shipped winners, as a
    user's first run would."""
    from repro_torch.kernels import autotune
    t0 = time.perf_counter()
    shipped = autotune.pretuned_status()
    saved = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(tmp, "at.json")
    autotune.reset()
    legs = []
    try:
        for case, op, shape in AUTOTUNE_LEG:
            fn = {"decode_attn": autotune.autotune_decode,
                  "attn": autotune.autotune_attention,
                  "matmul": autotune.autotune_matmul}[op]
            winner, timings = fn(*shape, dtype="bfloat16", device="cuda")
            counted = _autotune_default_call(op, shape)
            key = winner if op == "matmul" else winner[0]
            leg = dict(case=case, op=op, shape=list(shape),
                       heuristic=list(autotune.default_block(op, shape,
                                                             "bfloat16")),
                       winner=list(winner),
                       candidates=[[list(b), t["ms"], t["spread_ms"]]
                                   for b, t in timings.items()],
                       default_call_counted={str(c): n for c, n
                                             in counted.items()})
            legs.append(leg)
            if counted != {key: 1}:
                raise AssertionError(f"autotune {case}: the default call "
                                     f"counted {counted}, the winner is "
                                     f"{winner}")
    finally:
        if saved is None:
            os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE", None)
        else:
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = saved
        autotune.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    res = dict(shipped=shipped, legs=legs,
               phase_s=time.perf_counter() - t0)
    log(json.dumps({"autotune": res}))
    return res


# ---------------------------------------------------------------------------
# phase 4: the slice, end to end
# ---------------------------------------------------------------------------
#: device-time classes of the profiled run, by kernel-name fragment
KERNEL_CLASSES = (("decode_attention", ("decode_cluster_kernel",)),
                  ("flash_attention", ("flash_kernel", "flash_tc_kernel",
                                       "flash_split_kernel",
                                       "stage_kv_pieces_kernel")),
                  ("gemm", ("gemm", "gemv", "nvjet", "xmma", "cutlass")))


def device_profile(run, wall: float, classes=None):
    """Device time by kernel class (``classes``, default
    ``KERNEL_CLASSES``: a class's fragments, any of which in a kernel's
    name puts it there, or a predicate on the lower-cased name) of
    ``run()`` under ``torch.profiler`` (CUDA
    activity only, so the host is barely slowed and the trace stays
    small), against ``wall``, the host-clock time of an unprofiled run of
    the same work: the idle share is one minus busy over ``wall``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            by_name[ev.key] = (by_name.get(ev.key, 0.0)
                               + ev.self_device_time_total / 1e6)
    busy = sum(by_name.values())
    classes = classes or KERNEL_CLASSES
    by_class = {name: 0.0 for name, _ in classes}
    by_class["other"] = 0.0
    for key, sec in by_name.items():
        low = key.lower()
        cls = next((name for name, frags in classes
                    if (frags(low) if callable(frags)
                        else any(f in low for f in frags))), "other")
        by_class[cls] += sec
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_s=wall, device_busy_s=busy,
                device_idle_share=(1.0 - busy / wall) if busy else None,
                device_s_by_class=by_class,
                top_kernels=[[k[:90], sec] for k, sec in top],
                profiled_run_s=t1 - t0,
                trace_read_s=time.perf_counter() - t1)


def profile_run(eng, reqs) -> dict:
    """Where the device time goes in a short window of the slice: ``reqs``
    served once timed, then once under the profiler."""
    import torch
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    prof = device_profile(lambda: eng.run(reqs), time.perf_counter() - t0)
    return dict(requests=len(reqs), max_new=reqs[0].max_new, **prof)


PROMPTS = (1024, 128, 512, 4080, 768, 256, 896, 384)
ARRIVALS = (0, 0, 0, 0, 2, 4, 6, 8)
GEN = 32


#: depth of the overload and HA phases: the first 14 of the slice's 42
#: gemma2-9b layers, on its weights.  The whole stack runs in the slice,
#: speculative and generate phases; what these two phases gate
#: (admission, preemption, swap, degrade, faults, migration, the
#: journal) acts on whole rows at any depth.  Cut to keep the smoke
#: inside its time limit (PERF.md §4 has each phase's measured need)
FLEET_LAYERS = 14


def prefix_model(model, params, layers: int):
    """``model`` and ``params`` cut to their first ``layers`` layers (the
    weights are shared, not copied)."""
    return (model.with_cfg(n_layers=layers),
            dict(params, layers=params["layers"][:layers]))


def full_model(seed: int = 0):
    """gemma2-9b at full width under ``tp_bf16``, paged in 64-token pages,
    with random weights from ``seed`` (17.2 GiB): built once, shared by the
    serving phases."""
    import torch
    from repro_torch.models.registry import build_model
    model = build_model("gemma2-9b", policy="tp_bf16", device="cuda",
                        paged_kv=True, page_size=64)
    t0 = time.perf_counter()
    params = model.init(seed)
    torch.cuda.synchronize()
    log(f"gemma2-9b full width: {model.cfg.n_layers} layers, d_model "
        f"{model.cfg.d_model}, weights "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB, init "
        f"{time.perf_counter() - t0:.1f} s")
    return model, params


def reset_attention_counters() -> None:
    from repro_torch.launch.sharded_checks import reset_attention_launches
    reset_attention_launches()


def attention_counters(where: str, rule: set, flash: str = "tc",
                       decode: str = "mma", counted=None) -> dict:
    """The attention launch counters since the last reset (or
    ``counted``, a rank's ``sharded_checks.attention_launches()``),
    gated: both kernels launched, every flash launch on variant
    ``flash``, every decode launch on route ``decode`` at a cluster size
    in ``rule``."""
    from repro_torch.launch.sharded_checks import attention_launches
    counted = counted if counted is not None else attention_launches()
    launches, variants = counted["launches"], counted["variants"]
    by_cluster = counted["decode_launches_by_cluster"]
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{where}: {name} was not launched")
    want = {"flash_attention": {"tc": 0, "split": 0, "fma": 0},
            "decode_attention": {"mma": 0, "fma": 0}}
    want["flash_attention"][flash] = launches["flash_attention"]
    want["decode_attention"][decode] = launches["decode_attention"]
    if variants != want:
        raise AssertionError(f"{where}: attention launches by variant "
                             f"{variants}: flash must all be {flash}, "
                             f"decode all {decode}")
    if (sum(by_cluster.values()) != launches["decode_attention"]
            or not set(by_cluster) <= rule):
        raise AssertionError(f"{where}: decode launches by cluster size "
                             f"{by_cluster}: kernels.ops picks "
                             f"{sorted(rule)}")
    q_rows_gate(where, counted)
    return counted


def q_rows_gate(where: str, counted: dict) -> None:
    """Every ``flash_tc`` launch at the query tile ``kernels.ops`` picked
    for it: the wrapper's launches by tile equal the ops' picks."""
    if counted["flash_launches_by_q_rows"] != counted["flash_picks_by_q_rows"]:
        raise AssertionError(f"{where}: flash_tc launches by query tile "
                             f"{counted['flash_launches_by_q_rows']}, "
                             f"kernels.ops picked "
                             f"{counted['flash_picks_by_q_rows']}")


def no_attention_counters(where: str) -> dict:
    """The attention launch counters since the last reset, gated to zero
    (an arch without attention), in ``attention_counters``' layout."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    launches = {"decode_attention": decode_attention_cuda.launches,
                "flash_attention": flash_attention_cuda.launches}
    if any(launches.values()):
        raise AssertionError(f"{where}: attention kernels launched "
                             f"{launches}, the arch has no attention")
    return dict(launches=launches,
                variants={"flash_attention": {"tc": 0, "split": 0,
                                              "fma": 0},
                          "decode_attention": {"mma": 0, "fma": 0}},
                decode_launches_by_cluster={}, decode_launches_by_group={},
                flash_launches_by_dims={}, flash_launches_noncausal=0,
                flash_launches_by_q_rows={}, flash_picks_by_q_rows={},
                tuned_picks={})


def flash_dims() -> dict:
    """The flash launches since the last reset by head dims, "DxDv"."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    return {f"{d}x{dv}": n
            for (d, dv), n in flash_attention_cuda.launches_by_dims.items()}


def cluster_rule(model, rows: int, max_pages: int) -> set:
    """The cluster sizes ``kernels.ops`` picks for ``rows`` batch rows over
    ``max_pages``-page tables of the model's pool, one per layer kind."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models.attention import kv_store_dtype
    cfg = model.cfg
    return {kops.decode_pick(rows * cfg.n_kv_heads, max_pages, cfg.page_size,
                             cfg.n_heads // cfg.n_kv_heads, cfg.head_dim,
                             kv_store_dtype(model.policy), "cuda",
                             spec.window)
            for spec in cfg.layer_list()}


def strip_rule(cfg, rows: int, lens) -> set:
    """The cluster sizes ``kernels.ops`` picks for ``rows`` contiguous bf16
    strips of each length in ``lens``."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.decode_attention import STRIP_UNIT
    return {kops.decode_pick(rows * cfg.n_kv_heads, -(-n // STRIP_UNIT),
                             STRIP_UNIT, cfg.n_heads // max(1, cfg.n_kv_heads),
                             cfg.head_dim, torch.bfloat16, "cuda")
            for n in lens}


def slice_requests(model, seed: int = 0) -> list:
    """The slice's queue: ``PROMPTS`` arriving at ``ARRIVALS``, ``GEN``
    tokens each, prompt tokens from ``seed``."""
    import numpy as np
    from repro_torch.launch.engine import Request
    rng = np.random.RandomState(seed)
    return [Request(rid=i, tokens=rng.randint(0, model.cfg.vocab,
                                              size=p).tolist(),
                    max_new=GEN, arrival=a)
            for i, (p, a) in enumerate(zip(PROMPTS, ARRIVALS))]


def slice_phase(model=None, params=None, seed: int = 0) -> dict:
    """Returns the phase's record, with the plain engine's streams under
    ``streams`` (the speculative phase's reference)."""
    import torch
    from repro_torch.launch.engine import ContinuousEngine, Request

    if model is None:
        model, params = full_model(seed)
    reqs = slice_requests(model, seed)
    max_len = max(p + GEN for p in PROMPTS)
    eng = ContinuousEngine(model, params, slots=4, max_len=max_len,
                           chunk=256)
    eng.run(reqs)                                    # warm-up
    reset_attention_counters()
    t0 = time.perf_counter()
    fin, stats = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = attention_counters(
        "slice", cluster_rule(model, eng.slots, eng.max_pages))
    for f in fin:
        if len(f.tokens) != GEN:
            raise AssertionError(f"request {f.rid}: {len(f.tokens)} of "
                                 f"{GEN} tokens")
    if stats["pages_live_end"] != 0:
        raise AssertionError(f"pool did not drain: {stats}")
    n_tok = sum(len(f.tokens) for f in fin)
    prompt_tok = sum(PROMPTS)
    res = dict(requests=len(fin), prompt_tokens=prompt_tok,
               generated_tokens=n_tok, wall_s=wall,
               prefill_ms=stats["prefill_s"] * 1e3,
               decode_ms_per_round=(stats["decode_s"] * 1e3
                                    / max(1, stats["decode_rounds"])),
               decode_rounds=stats["decode_rounds"],
               tok_s=n_tok / wall, peak_live_pages=stats["peak_live_pages"],
               max_len=max_len, crosses_window=max_len > 4096, **counted)
    log(json.dumps({"slice": res}))
    window = [dataclasses.replace(r, max_new=min(8, GEN), arrival=0)
              for r in reqs[:4]]
    log(json.dumps({"where_the_time_goes": profile_run(eng, window)}))

    # the same request through the plain versions
    pick = PROMPTS.index(512)
    plain = model.with_cfg(decode_backend="plain", prefill_backend="plain")
    toks = torch.tensor([reqs[pick].tokens], device="cuda")
    lg_k, _ = model.prefill(params, toks, max_len=512 + GEN)
    lg_p, _ = plain.prefill(params, toks, max_len=512 + GEN)
    if not (torch.isfinite(lg_k).all() and torch.isfinite(lg_p).all()):
        raise AssertionError("first-token logits are not finite")
    lerr = (lg_k - lg_p).abs().max().item()
    solo = ContinuousEngine(plain, params, slots=1, max_len=512 + GEN,
                            chunk=256)
    (fin_p,), _ = solo.run([Request(rid=0, tokens=reqs[pick].tokens,
                                    max_new=GEN)])
    agree = sum(a == b for a, b in zip(fin[pick].tokens, fin_p.tokens))
    top2 = lg_p[0, -1].float().topk(2).values
    cmp = dict(request=pick, prompt=512, logits_max_abs_err=lerr,
               logits_tol=LOGITS_TOL, logits_absmax=lg_k.abs().max().item(),
               plain_top2_margin=(top2[0] - top2[1]).item(),
               greedy_tokens_agree=agree, of=GEN,
               first_token_agree=fin[pick].tokens[0] == fin_p.tokens[0])
    log(json.dumps({"plain_vs_kernel": cmp}))
    if not lerr <= LOGITS_TOL:
        raise AssertionError(f"first-token logits differ by {lerr}")
    if not cmp["first_token_agree"]:
        raise AssertionError("the first generated token differs between the "
                             "kernel path and the plain path")
    return dict(res, streams={f.rid: f.tokens for f in fin})


# ---------------------------------------------------------------------------
# phase 4b: speculative decoding through the engine
# ---------------------------------------------------------------------------
#: draft depth of the speculative phase (the JAX package's A/B's)
SPEC_K = 3
#: the three speculative runs: engine options, the requests' own
#: ``no_speculate`` / ``spec_k`` (run ``a`` only), and whether the run
#: serves the whole queue or only its warm-up window (run ``c``, the
#: full-depth self-draft at ~0.45 s a round, cut to the window so the
#: smoke stays within its time)
SPEC_RUNS = (("a_1_repeat", dict(draft_repeats=1),
              {1: dict(no_speculate=True), 2: dict(spec_k=1)}, True),
             ("b_1_repeat_kv8", dict(draft_repeats=1,
                                     draft_policy="tp_bf16_kv8"), {}, True),
             ("c_self_draft", {}, {}, False))


def merge_counters(total: dict, part: dict) -> dict:
    """``attention_counters`` records of several runs, summed."""
    total = total or dict(launches={}, variants={},
                          decode_launches_by_cluster={},
                          decode_launches_by_group={},
                          flash_launches_by_dims={})
    for key in ("launches", "decode_launches_by_cluster",
                "decode_launches_by_group", "flash_launches_by_dims",
                "flash_launches_by_q_rows", "flash_picks_by_q_rows",
                "tuned_picks"):
        total.setdefault(key, {})
        for k, n in part.get(key, {}).items():
            total[key][k] = total[key].get(k, 0) + n
    for name, by in part["variants"].items():
        for v, n in by.items():
            total["variants"].setdefault(name, {})
            total["variants"][name][v] = total["variants"][name].get(v, 0) + n
    total["flash_launches_noncausal"] = (
        total.get("flash_launches_noncausal", 0)
        + part.get("flash_launches_noncausal", 0))
    return total


def verify_vs_step(model, params, seed: int = 0) -> dict:
    """``verify_chunk`` against ``SPEC_K + 1`` sequential ``decode_step``
    calls at full width, from two identical prefills of four ragged rows
    (the slice's first four prompts, cut to 1024 tokens): the largest
    logit difference, the cache bytes that differ, and the chunk's top-2
    margins (the step form's)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed + 7)
    lens = [min(p, 1024) for p in PROMPTS[:4]]
    toks = torch.zeros((4, max(lens)), dtype=torch.int64)
    for r, n in enumerate(lens):
        toks[r, :n] = torch.from_numpy(rng.randint(0, model.cfg.vocab,
                                                   size=n))
    dev = model.device
    toks, lens = toks.to(dev), torch.tensor(lens, device=dev)
    k1 = SPEC_K + 1
    max_len = toks.shape[1] + k1
    pre = lambda: model.prefill(params, toks, max_len=max_len,
                                prompt_lens=lens)
    lg0, c_seq = pre()
    _, c_chk = pre()
    tok = lg0[:, -1].argmax(-1).to(torch.int32)[:, None]
    chunk, seq = [tok], []
    for i in range(k1):
        lg, c_seq = model.decode_step(params, chunk[-1], c_seq, lens + i,
                                      kv_len=lens + i + 1)
        seq.append(lg[:, -1])
        chunk.append(lg[:, -1].argmax(-1).to(torch.int32)[:, None])
    seq = torch.stack(seq, 1)
    offs = lens[:, None] + torch.arange(k1, device=dev)
    v_lg, c_chk = model.verify_chunk(params, torch.cat(chunk[:k1], 1),
                                     c_chk, lens, kv_len=offs + 1)
    if not (torch.isfinite(seq).all() and torch.isfinite(v_lg).all()):
        raise AssertionError("verify_vs_step: logits are not finite")
    diff = (seq - v_lg).abs().max().item()
    differ = sum(int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
                 for ca, cb in zip(c_seq, c_chk)
                 for a, b in ((ca.k_pool, cb.k_pool), (ca.v_pool, cb.v_pool)))
    top2 = seq.topk(2, dim=-1).values
    return dict(rows=4, prompts=lens.tolist(), positions=k1,
                logits_max_abs_diff=diff, bitwise=diff == 0.0,
                cache_bytes_differ=differ,
                min_top2_margin=(top2[..., 0] - top2[..., 1]).min().item(),
                argmax_agree=bool(torch.equal(seq.argmax(-1),
                                              v_lg.argmax(-1))))


def near_tie_check(model, params, req, plain, got, vdiff: float,
                   where: str = "speculative") -> dict:
    """Where ``got`` first parts from ``plain`` (the plain engine's stream
    of ``req``), the plain stream's logits there, replayed by one prefill
    of the prompt and the plain tokens before it; the two candidate
    tokens' logits must lie within ``2 (vdiff + LOGITS_TOL)`` of each
    other (``vdiff``: verify against step at full width; ``LOGITS_TOL``:
    what a prefill replay may differ by from the engine's decode reads).
    Returns the record, or None when the streams are equal."""
    import torch
    s = next((i for i, (a, b) in enumerate(zip(plain, got)) if a != b),
             None)
    if s is None:
        return None
    ctx = torch.tensor([list(req.tokens) + list(plain[:s])],
                       device=model.device)
    lg, _ = model.prefill(params, ctx, max_len=ctx.shape[1] + 1)
    gap = abs(lg[0, -1, plain[s]].item() - lg[0, -1, got[s]].item())
    rec = dict(rid=req.rid, step=s, plain_token=plain[s], token=got[s],
               replay_gap=gap, bound=2 * (vdiff + LOGITS_TOL))
    if not gap <= rec["bound"]:
        raise AssertionError(f"{where}: request {req.rid} parts from the "
                             f"plain stream at step {s} where the two "
                             f"tokens' logits differ by {gap}: {rec}")
    return rec


class BurstWatch:
    """A model proxy that records each ``speculate_burst``'s per-row draft
    caps, entry state and live-length growth (the no_speculate gate)."""

    def __init__(self, model):
        self._model, self.bursts = model, []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def speculate_burst(self, params, tok, caches, pos, lens, done, limit,
                        **kw):
        r = self._model.speculate_burst(params, tok, caches, pos, lens, done,
                                        limit, **kw)
        self.bursts.append(dict(k_rows=kw["k_rows"].tolist(),
                                done_in=done.tolist(), done_out=r[6].tolist(),
                                grew=(r[5] - lens).tolist(), rounds=r[1]))
        return r


def one_token_a_round(watch: BurstWatch) -> int:
    """Gate: a row with draft cap 0 grows by one token a round it is live
    (exactly its burst's rounds while it stays live, at most that when it
    finishes inside the burst).  Returns the row-bursts checked."""
    seen = 0
    for bu in watch.bursts:
        for cap, d0, d1, grew in zip(bu["k_rows"], bu["done_in"],
                                     bu["done_out"], bu["grew"]):
            if cap != 0 or d0:
                continue
            seen += 1
            if grew > bu["rounds"] or (not d1 and grew != bu["rounds"]):
                raise AssertionError(f"speculative: a no_speculate row grew "
                                     f"{grew} tokens in {bu['rounds']} "
                                     f"rounds")
    if not seen:
        raise AssertionError("speculative: the no_speculate row never ran")
    return seen


def speculative_phase(model, params, plain: dict, seed: int = 0) -> dict:
    """Self-speculative greedy serving of the slice's queue through
    ``ContinuousEngine(spec_k=SPEC_K)`` (4 slots, chunk 256, pages of 64,
    ``max_len`` the slice's + ``SPEC_K``), in the three ``SPEC_RUNS``,
    each after a warm-up on its first four requests.  ``plain`` is the
    slice phase's record (its streams and tok/s).  Gates: every request gets its ``GEN`` tokens and
    the pool drains; each run's streams equal the plain engine's up to a
    row's first near tie (``near_tie_check``, against the verify-vs-step
    difference ``verify_vs_step`` measures); ``0 < spec_accept_rate <=
    1``; every decode launch (draft steps and verify folds) at the size
    ``cluster_rule`` names for the slots, every flash launch ``flash_tc``
    at 256x256; a repeat of run ``a`` repeats its tokens and
    ``spec_rounds``, and in it the ``no_speculate`` row emits one token a
    round."""
    import dataclasses as dc
    from repro_torch.launch.engine import ContinuousEngine

    vs = verify_vs_step(model, params, seed)
    log(json.dumps({"verify_vs_step": vs}))
    base = slice_requests(model, seed)
    max_len = max(p + GEN for p in PROMPTS) + SPEC_K
    counted, runs = {}, {}
    for name, opts, per_req, whole in SPEC_RUNS:
        reqs = [dc.replace(r, **per_req.get(r.rid, {})) for r in base]
        # the first four requests, 8 tokens each: every shape of the run
        window = [dc.replace(r, max_new=min(8, GEN), arrival=0)
                  for r in reqs[:4]]
        if not whole:
            reqs = window
        eng = ContinuousEngine(model, params, slots=4, max_len=max_len,
                               chunk=256, spec_k=SPEC_K, **opts)
        eng.run(window)                              # warm-up
        reset_attention_counters()
        t0 = time.perf_counter()
        fin, stats = eng.run(reqs)
        eng._sync()
        wall = time.perf_counter() - t0
        c = attention_counters(f"speculative {name}",
                               cluster_rule(model, eng.slots, eng.max_pages))
        if set(c["flash_launches_by_dims"]) != {"256x256"}:
            raise AssertionError(f"speculative {name}: flash launches by "
                                 f"dims {c['flash_launches_by_dims']}")
        counted = merge_counters(counted, c)
        for f, r in zip(fin, reqs):
            if len(f.tokens) != r.max_new:
                raise AssertionError(f"speculative {name}: request {f.rid} "
                                     f"got {len(f.tokens)} of {r.max_new} "
                                     f"tokens")
        if stats["pages_live_end"] != 0:
            raise AssertionError(f"speculative {name}: pool did not drain")
        rate = stats["spec_accept_rate"]
        if not 0.0 < rate <= 1.0:
            raise AssertionError(f"speculative {name}: accept rate {rate}")
        ties = [t for t in (near_tie_check(model, params, r,
                                           plain["streams"][r.rid], f.tokens,
                                           vs["logits_max_abs_diff"])
                            for r, f in zip(reqs, fin)) if t is not None]
        n_tok = sum(len(f.tokens) for f in fin)
        rec = dict(tok_s=n_tok / wall, wall_s=wall,
                   ms_per_round=(stats["decode_s"] * 1e3
                                 / max(1, stats["decode_rounds"])),
                   decode_rounds=stats["decode_rounds"],
                   prefill_ms=stats["prefill_s"] * 1e3,
                   spec_rounds=stats["spec_rounds"],
                   spec_emitted=stats["spec_emitted"],
                   spec_accept_rate=rate, plain_tok_s=plain["tok_s"],
                   queue="whole" if whole else "window",
                   vs_plain=((n_tok / wall) / plain["tok_s"] if whole
                             else None),
                   plain_ms_per_round=plain["decode_ms_per_round"],
                   near_ties=ties, opts=opts,
                   requests={str(k): v for k, v in per_req.items()},
                   decode_launches_by_cluster=c["decode_launches_by_cluster"])
        if name.startswith("a"):
            watch = BurstWatch(model)
            eng.model = watch
            fin2, stats2 = eng.run(reqs)
            eng.model = model
            if ([f.tokens for f in fin2] != [f.tokens for f in fin]
                    or stats2["spec_rounds"] != stats["spec_rounds"]):
                raise AssertionError(f"speculative {name}: a repeat run "
                                     f"changed tokens or spec_rounds")
            rec["repeat_spec_rounds"] = stats2["spec_rounds"]
            rec["no_speculate_row_bursts"] = one_token_a_round(watch)
            rec["where_the_time_goes"] = profile_run(eng, window)
        runs[name] = rec
        del eng
    res = dict(spec_k=SPEC_K, max_len=max_len, card=card_line(),
               verify_vs_step=vs, runs=runs, **counted)
    log(json.dumps({"speculative": res}))
    return res


# ---------------------------------------------------------------------------
# phase 5: Model.generate, both loop forms
# ---------------------------------------------------------------------------
GEN_PROMPTS = (1024, 512, 256, 64)
GEN_LEN = 32
GEN_PENALTIES = dict(repetition_penalty=1.1, presence_penalty=0.5)
GEN_STOP_SAMPLING = dict(temperature=0.7, top_k=64, top_p=0.9)
#: tokens of the generate phase's profiled scan
GEN_PROFILE_LEN = 8


def generate_phase(model, params, seed: int = 0) -> dict:
    """``Model.generate`` at full width: a ragged batch of four prompts
    (1024/512/256/64, right-padded), 32 tokens each, greedy with
    repetition 1.1 and presence 0.5 penalties and the non-finite guard.
    Gates: the while form's tokens equal the scan form's; with a stop
    token that a one-row run emits first at step >= 4 (sampled at
    ``GEN_STOP_SAMPLING`` from a seeded generator: greedy streams at
    random weights repeat their first tokens), the while form exits early
    (the scan form runs every step) with the scan form's tokens; guard
    counts 0; the prefix-sharing parity (shared against
    identity page tables) gives 0 token mismatches and 0.0 logit
    difference; both attention kernels launched on their gated routes;
    the prefill and first token against the plain versions
    (``_generate_vs_plain``)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import prefix_sharing_parity
    from repro_torch.models.paged import num_pages

    rng = np.random.RandomState(seed + 5)
    width = max(GEN_PROMPTS)
    toks = torch.zeros((len(GEN_PROMPTS), width), dtype=torch.int64)
    for r, n in enumerate(GEN_PROMPTS):
        toks[r, :n] = torch.from_numpy(rng.randint(0, model.cfg.vocab,
                                                   size=n))
    toks = toks.to(model.device)
    lens = torch.tensor(GEN_PROMPTS, device=model.device)
    kw = dict(gen_len=GEN_LEN, prompt_lens=lens, guard_nonfinite=True,
              return_trips=True, **GEN_PENALTIES)
    sync = torch.cuda.synchronize if model.device.type == "cuda" else (
        lambda: None)
    model.generate(params, toks, **kw)                   # warm-up
    sync()
    reset_attention_counters()
    t0 = time.perf_counter()
    first = model.generate(params, toks, **{**kw, "gen_len": 1},
                           return_logits=True)         # prefill + token 0
    sync()
    t1 = time.perf_counter()
    scan, _, trips_scan, bad_scan = model.generate(params, toks, loop="scan",
                                                   **kw)
    sync()
    t2 = time.perf_counter()
    whl, _, trips_while, bad_while = model.generate(params, toks,
                                                    loop="while", **kw)
    sync()
    max_pages = num_pages(width + GEN_LEN, model.cfg.page_size)
    counted = attention_counters(
        "generate", cluster_rule(model, len(GEN_PROMPTS), max_pages))
    # the profiled window is a short scan: reading a trace back costs about
    # 0.2 ms an event, and the whole 32-token scan's took 30 s
    short = {**kw, "gen_len": GEN_PROFILE_LEN}
    sync()
    t3 = time.perf_counter()
    model.generate(params, toks, loop="scan", **short)
    sync()
    where = device_profile(
        lambda: model.generate(params, toks, loop="scan", **short),
        time.perf_counter() - t3)
    where["gen_len"] = GEN_PROFILE_LEN
    if not torch.equal(scan, whl) or trips_scan != trips_while:
        raise AssertionError("generate: the while form's tokens differ from "
                             "the scan form's")
    if int(bad_scan.sum()) or int(bad_while.sum()):
        raise AssertionError(f"generate: guard counts {bad_scan.tolist()}")
    plain = _generate_vs_plain(model, params, toks, kw, first)

    # early exit: one row, the stop token it first emits at step >= 4.
    # Greedy streams at random weights repeat a few tokens from the first
    # steps on, so this check samples (both forms from identically seeded
    # generators, hence the same draws)
    one = toks[:1, :GEN_PROMPTS[0]]
    kw1 = dict(gen_len=GEN_LEN, return_trips=True, **GEN_STOP_SAMPLING,
               **GEN_PENALTIES)
    seeded = lambda: torch.Generator(device=model.device).manual_seed(seed)
    base = model.generate(params, one, generator=seeded(),
                          **kw1)[0][0].tolist()
    new = [s for s in range(4, GEN_LEN) if base[s] not in base[:s]]
    if not new:
        raise AssertionError(f"generate: the sampled row emits no new token "
                             f"at step >= 4 to stop on: {base}")
    step, stop = new[0], base[new[0]]
    stop_runs = {loop: model.generate(params, one, loop=loop,
                                      stop_token=stop, generator=seeded(),
                                      **kw1)
                 for loop in ("scan", "while")}
    (g_s, _, t_s), (g_w, _, t_w) = stop_runs["scan"], stop_runs["while"]
    if not (torch.equal(g_s, g_w) and t_w == step < GEN_LEN - 1
            and t_s == GEN_LEN - 1):
        raise AssertionError(f"generate: stop token {stop} first emitted at "
                             f"step {step}: while trips {t_w}, scan trips "
                             f"{t_s}, tokens equal {torch.equal(g_s, g_w)}")

    # prefix sharing on the card: a uniform batch of 4 x 512
    d_tok, d_lg, _, _, n_pages, live = prefix_sharing_parity(
        model, params, toks[:, :512].clone(), gen=8, max_len=512 + 8)
    if d_tok != 0 or d_lg != 0.0:
        raise AssertionError(f"prefix sharing changed outputs: {d_tok} "
                             f"tokens, max |dlogits| {d_lg}")
    n_tok = len(GEN_PROMPTS) * GEN_LEN
    res = dict(prompts=list(GEN_PROMPTS), gen_len=GEN_LEN, **GEN_PENALTIES,
               prefill_s=t1 - t0, scan_s=t2 - t1,
               decode_ms_per_step=(t2 - t1 - (t1 - t0)) * 1e3
               / (GEN_LEN - 1), tok_s=n_tok / (t2 - t1), trips=trips_scan,
               greedy_heads=scan[:, :8].tolist(), stop_check_sampling=dict(
                   GEN_STOP_SAMPLING, seed=seed),
               stop_token=stop, stop_step=step, while_trips_with_stop=t_w,
               scan_trips_with_stop=t_s, guard_counts=bad_scan.tolist(),
               prefix_sharing=dict(token_mismatches=d_tok,
                                   max_abs_logit_diff=d_lg,
                                   live_pages=live, n_pages=n_pages),
               plain_vs_kernel=plain, card=card_line(),
               where_the_time_goes=where, **counted)
    log(json.dumps({"generate": res}))
    return res


class RouteTape:
    """The MoE router's top-k choices of one pass, recorded
    (``record``) and chosen again by a later pass (``replay``).  The MoE
    phases' plain-path logit gates hold the attention kernels against
    their plain versions with the expert choice pinned: a bf16 difference
    in the router's input flips a near-tied top-k choice (one expert's
    output in place of another's), which is not the kernels' doing.  The
    free-routing difference and the count of flipped choices
    (``flips``) are reported beside it.  A replayed pass takes its own
    router probabilities at the recorded experts, renormalized as
    ``moe.route`` does."""

    def __init__(self):
        self.idx = []

    @contextlib.contextmanager
    def _patched(self, fn):
        from repro_torch.models import moe
        orig = moe.route
        moe.route = fn
        try:
            yield self
        finally:
            moe.route = orig

    def record(self):
        from repro_torch.models import moe
        orig = moe.route

        def rec(x, router, cfg):
            r = orig(x, router, cfg)
            self.idx.append(r[2])
            return r
        return self._patched(rec)

    def replay(self, steps_of: int = 0):
        """Recorded call i serves replayed call i; with ``steps_of`` = L
        (the MoE layers of a one-row prefill recorded), replayed call i is
        token i // L of layer i % L: the same prompt fed token by token."""
        import torch
        calls = iter(range(1 << 30))

        def pinned(x, router, cfg):
            i = next(calls)
            idx = (self.idx[i] if not steps_of else
                   self.idx[i % steps_of][i // steps_of:i // steps_of + 1])
            probs = torch.softmax(x.float() @ router.float(), dim=-1)
            gates = probs.gather(-1, idx)
            if cfg.router_norm_topk:
                gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                            min=1e-9)
            return probs, gates, idx
        return self._patched(pinned)

    def flips(self, other: "RouteTape") -> int:
        """Token-layer pairs whose expert sets differ from ``other``'s."""
        return sum(int((a.sort(-1).values != b.sort(-1).values).any(-1)
                       .sum()) for a, b in zip(self.idx, other.idx))


def _tape(model):
    """A ``RouteTape`` for a MoE model, else None."""
    return RouteTape() if model.cfg.moe is not None else None


def _recording(tape):
    return tape.record() if tape is not None else contextlib.nullcontext()


def _generate_vs_plain(model, params, toks, kw, first,
                       penalties=GEN_PENALTIES, tape=None) -> dict:
    """``generate``'s prefill and first token through the plain versions
    of both attention kernels, against ``first`` (the kernel path's).
    Gates: first-token logits within ``LOGITS_TOL``, and each row's first
    token equal unless the plain path's top-2 margin of the logits
    penalized by ``penalties`` is at most twice the logit difference (a near tie that bf16
    rounding may flip).  ``tape`` (a MoE model: the kernel pass's
    ``RouteTape``) pins the plain pass's expert choices; the free pass's
    difference and flips are reported."""
    from repro_torch.models.transformer import apply_penalties, token_counts
    plain = model.with_cfg(decode_backend="plain", prefill_backend="plain")
    gen1 = lambda: plain.generate(params, toks, **{**kw, "gen_len": 1},
                                  return_logits=True)
    routing = {}
    if tape is not None:
        free = RouteTape()
        with free.record():
            lg_free = gen1()[1][:, 0]
        with tape.replay():
            got = gen1()
        routing = dict(
            free_routing_logits_max_abs_err=(
                first[1][:, 0] - lg_free).abs().max().item(),
            route_flips=tape.flips(free),
            route_choices=sum(int(i.shape[0]) for i in tape.idx))
    else:
        got = gen1()
    (tok_k, lg_k), (tok_p, lg_p) = first[:2], got[:2]
    lg_k, lg_p = lg_k[:, 0], lg_p[:, 0]
    if not (lg_k.isfinite().all() and lg_p.isfinite().all()):
        raise AssertionError("generate: first-token logits are not finite")
    lerr = (lg_k - lg_p).abs().max().item()
    cnt = token_counts(toks, model.vocab_out, kw["prompt_lens"])
    pen = apply_penalties(lg_p, cnt, **penalties)
    top2 = pen.topk(2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    agree = (tok_k[:, 0] == tok_p[:, 0]).tolist()
    res = dict(logits_max_abs_err=lerr, logits_tol=LOGITS_TOL,
               first_tokens_agree=agree, plain_top2_margins=margins,
               **routing)
    if not lerr <= LOGITS_TOL:
        raise AssertionError(f"generate: first-token logits differ from the "
                             f"plain path's by {lerr}")
    for r, (ok, m) in enumerate(zip(agree, margins)):
        if not ok and m > 2 * lerr:
            raise AssertionError(f"generate: row {r}'s first token differs "
                                 f"from the plain path's at a top-2 margin "
                                 f"{m} > 2 x {lerr}")
    return res


# ---------------------------------------------------------------------------
# phase 6: the overload-safe engine
# ---------------------------------------------------------------------------
#: the overload queue: (arrival, prompt, budget, priority, no_degrade);
#: two bursts, priority 2 (with deadlines) only in the second
OVERLOAD = ((0, 1536, 40, 0, False), (0, 896, 24, 1, False),
            (0, 2048, 48, 0, True), (0, 640, 32, 0, False),
            (0, 384, 16, 1, False), (0, 1152, 28, 0, False),
            (8, 1792, 36, 2, False), (8, 256, 20, 2, False),
            (8, 1280, 44, 1, True), (8, 128, 16, 2, False),
            (8, 768, 24, 0, False), (8, 512, 32, 1, False))
OVERLOAD_SAMPLING = dict(temperature=0.7, top_k=64, top_p=0.9,
                         repetition_penalty=1.1, presence_penalty=0.3)
OVERLOAD_COUNTERS = ("preemptions", "preempt_swap", "degraded",
                     "shed_events", "poisoned_rounds", "faults_exhaust",
                     "faults_slow")
SCHEDULE = ("rid", "admit_round", "finish_round", "preemptions", "sheds",
            "degraded", "deadline_miss")


def overload_queue(vocab: int, seed: int = 0):
    """The overload phase's requests, prompt tokens from ``seed`` taken
    mod ``vocab``; priority-2 requests carry a deadline."""
    import numpy as np
    from repro_torch.launch.engine import Request
    rng = np.random.RandomState(seed + 7)
    return [Request(rid=i,
                    tokens=(rng.randint(0, 256000, size=p) % vocab).tolist(),
                    max_new=b, arrival=a, priority=pri,
                    deadline=(a + 2 * b + 24 if pri == 2 else None),
                    no_degrade=nd)
            for i, (a, p, b, pri, nd) in enumerate(OVERLOAD)]


def overload_engine(model, params, **kw):
    """4 slots, chunk 256, a pool of 1.5x the largest request's worst
    case (+1 scratch), swap preemption with fp8 degrade, the sampling
    above, and a fault plan with one exhaustion episode, one masked
    poison round, the first swap-out corrupted and one slow burst."""
    from repro_torch.launch.engine import ContinuousEngine
    from repro_torch.models.paged import num_pages
    from repro_torch.train.fault import ServeFaultPlan
    page = model.cfg.page_size
    worst = max(num_pages(p + b, page) for _, p, b, _, _ in OVERLOAD)
    max_len = max(p + b for _, p, b, _, _ in OVERLOAD)
    plan = ServeFaultPlan(exhaust_at=(2,), exhaust_for=3, poison_at=(14,),
                          corrupt_swap_at=(0,), slow_at=(20,), slow_s=0.05)
    args = dict(slots=4, max_len=max_len, chunk=256,
                n_pages=worst * 3 // 2 + 1, preempt="swap",
                degrade_fmt="fp8", fault_plan=plan, seed=11,
                **OVERLOAD_SAMPLING)
    args.update(kw)
    return ContinuousEngine(model, params, **args)


def overload_gates(fin, stats, reqs, where: str) -> None:
    for r, f in zip(reqs, fin):
        if f.rid != r.rid or len(f.tokens) != r.max_new:
            raise AssertionError(f"{where}: request {r.rid} got "
                                 f"{len(f.tokens)} of {r.max_new} tokens")
    if stats["pages_live_end"] != 0:
        raise AssertionError(f"{where}: pool did not drain: {stats}")
    low = {k: stats[k] for k in OVERLOAD_COUNTERS if stats[k] < 1}
    if low:
        raise AssertionError(f"{where}: counters that never fired: {low}")
    if not stats["sdc_detected"] == stats["sdc_injected"] >= 1:
        raise AssertionError(f"{where}: SDC injected "
                             f"{stats['sdc_injected']}, detected "
                             f"{stats['sdc_detected']}")


def _sampling_step_ms(model, eng) -> dict:
    """Device time of one round's sampling step at [slots, vocab]: guard,
    penalties, top-k, top-p and the draw (``_pick`` as the engine calls
    it), summed over its kernels under ``torch.profiler``, and the same
    step's time between CUDA events (host launch gaps included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.transformer import _pick, token_counts
    g = torch.Generator(device="cuda").manual_seed(3)
    v = model.vocab_out
    lg = 8.0 * torch.randn((eng.slots, v), generator=g, device="cuda")
    hist = torch.randint(0, model.cfg.vocab, (eng.slots, 2048), generator=g,
                         device="cuda")
    cnt = token_counts(hist, v)
    pen = dict(repetition_penalty=eng.repetition_penalty,
               presence_penalty=eng.presence_penalty)
    step = lambda: _pick(lg, counts=cnt, penalties=pen, generator=g,
                         temperature=eng.temperature, top_k=eng.top_k,
                         top_p=eng.top_p, guard=True)
    iters = 50
    events_ms = cuda_ms(step, iters)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    busy = sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA)
    return dict(shape=[eng.slots, v], device_ms=busy / 1e3 / iters,
                events_ms=events_ms)


def overload_phase(model, params, seed: int = 0) -> dict:
    """The overload-safe engine at full width: 12 requests (prompts
    128-2048, budgets 16-48) in two bursts (rounds 0 and 8), priorities
    {0, 1, 2}, deadlines on priority 2, two ``no_degrade``, on a pool of
    1.5x the largest request's worst case, with swap preemption, fp8
    degrade, sampling with penalties and a fault plan (see
    ``overload_engine``).  Gates (``overload_gates``): every request gets
    its whole budget, the pool drains, every overload counter fires, SDC
    detected == injected >= 1; a second run with the same seed repeats
    every token; the per-request schedule equals the same queue's through
    the port on the CPU at the reduced config; the attention launches
    take their gated routes.  Reported, not gated: the greedy token
    agreement of a swap run without degrade against an unpressured run."""
    import torch
    from repro_torch.models.registry import build_model

    reqs = overload_queue(model.cfg.vocab, seed)
    eng = overload_engine(model, params)
    reset_attention_counters()
    t0 = time.perf_counter()
    fin, stats = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = attention_counters(
        "overload", cluster_rule(model, eng.slots, eng.max_pages))
    overload_gates(fin, stats, reqs, "overload")
    again, _ = eng.run(reqs)
    if [f.tokens for f in again] != [f.tokens for f in fin]:
        raise AssertionError("overload: a second run with the same seed "
                             "gave other tokens")
    sched = lambda fs: [tuple(getattr(f, k) for k in SCHEDULE) for f in fs]
    small = build_model("gemma2-9b", policy="tp_bf16", reduced=True,
                        device="cpu", paged_kv=True,
                        page_size=model.cfg.page_size)
    cpu_reqs = overload_queue(small.cfg.vocab, seed)
    cpu_fin, cpu_stats = overload_engine(small, small.init(0)).run(cpu_reqs)
    overload_gates(cpu_fin, cpu_stats, cpu_reqs, "overload on the CPU")
    if sched(cpu_fin) != sched(fin):
        raise AssertionError(f"overload: the schedule differs from the "
                             f"CPU's:\n{sched(fin)}\n{sched(cpu_fin)}")

    # reported: greedy swap without degrade against an unpressured run (a
    # slot for every request and an ample pool: nothing preempted or shed)
    greedy = dict(temperature=0.0, repetition_penalty=None,
                  presence_penalty=None, fault_plan=None)
    streams = {}
    for name, kw in (("pressured", dict(degrade_fmt=None)),
                     ("unpressured", dict(n_pages=None, slots=len(reqs)))):
        f2, s2 = overload_engine(model, params, **greedy, **kw).run(reqs)
        streams[name] = ([f.tokens for f in f2], s2["preemptions"])
    pairs = [(a, b) for x, y in zip(streams["pressured"][0],
                                    streams["unpressured"][0])
             for a, b in zip(x, y)]
    agree = sum(a == b for a, b in pairs)

    n_tok = sum(len(f.tokens) for f in fin)
    gb = lambda nbytes, s: nbytes / s / 1e9 if s else None
    res = dict(
        requests=len(fin), generated_tokens=n_tok, wall_s=wall,
        tok_s=n_tok / wall, n_pages=stats["n_pages"],
        decode_rounds=stats["decode_rounds"],
        decode_ms_per_round=(stats["decode_s"] * 1e3
                             / max(1, stats["decode_rounds"])),
        prefill_s=stats["prefill_s"],
        counters={k: stats[k] for k in (
            "preemptions", "preempt_swap", "preempt_reingest",
            "preempt_restart", "resumed", "degraded", "shed_events",
            "poisoned_rounds", "nonfinite_prefill", "stragglers",
            "faults_exhaust", "faults_slow", "sdc_injected", "sdc_detected",
            "sdc_reingest", "deadline_total", "deadline_misses")},
        swap_out_bytes=stats["swap_out_bytes"],
        swap_out_s=stats["swap_out_s"],
        swap_out_gb_s=gb(stats["swap_out_bytes"], stats["swap_out_s"]),
        swap_in_bytes=stats["swap_in_bytes"], swap_in_s=stats["swap_in_s"],
        swap_in_gb_s=gb(stats["swap_in_bytes"], stats["swap_in_s"]),
        swap_crc_s=stats["swap_crc_s"],
        sampling_step=_sampling_step_ms(model, eng),
        schedule_equals_cpu=True, repeat_tokens_equal=True,
        greedy_swap_vs_unpressured=dict(
            tokens_agree=agree, of=len(pairs),
            preemptions=[streams["pressured"][1],
                         streams["unpressured"][1]]),
        schedule=sched(fin), card=card_line(), **counted)
    log(json.dumps({"overload": res}))
    return res


# ---------------------------------------------------------------------------
# phase 6b: replica fault tolerance, a meshless fleet on the one card
# ---------------------------------------------------------------------------
#: the HA queue, ``synthetic_trace(*HA_TRACE, vocab, flavor="session")``:
#: 12 requests in four 3-turn sessions, prompts 256-1548, budgets 4-16
HA_TRACE = (12, 4, 1024, 64)
#: each replica's engine (two replicas share the one copy of the weights)
HA_ENGINE = dict(slots=2, chunk=256, burst_cap=8)
#: the hang leg's residents: (count, prompt, budget)
HA_HANG = (4, 512, 24)
#: the replay leg serves the HA queue's first ``HA_REPLAY`` requests
HA_REPLAY = 6


class TimedJournal:
    """A ``RequestJournal`` whose appends (JSON, write, flush, fsync) are
    timed on the host clock."""

    def __init__(self, path=None):
        from repro_torch.launch.journal import RequestJournal
        self.inner = RequestJournal(path)
        self.append_s = 0.0

    def append(self, kind, **payload):
        t0 = time.perf_counter()
        self.inner.append(kind, **payload)
        self.append_s += time.perf_counter() - t0

    def __getattr__(self, name):
        return getattr(self.inner, name)


def ha_fleet(model, params, reqs, **kw):
    """A ``ReplicatedEngine`` of ``HA_ENGINE`` replicas (2 unless
    ``replicas`` says otherwise) sized for ``reqs``."""
    from repro_torch.launch.engine import ReplicatedEngine
    args = dict(HA_ENGINE, replicas=2,
                max_len=max(r.prompt_len + r.max_new for r in reqs))
    args.update(kw)
    return ReplicatedEngine(model, params, **args)


def ha_leg(name, fleet, reqs, model, counted, run=None) -> tuple:
    """Serve ``reqs`` on ``fleet`` (or through ``run()``) with the
    attention counters reset first; gates: every request's budget, every
    pool drained, the launches on their routes.  Returns ``(finished,
    stats, record)``."""
    import torch
    reset_attention_counters()
    t0 = time.perf_counter()
    fin, stats = run() if run is not None else fleet.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted[name] = attention_counters(
        f"ha {name}", cluster_rule(model, fleet.engines[0].slots,
                                   fleet.engines[0].max_pages))
    for r, f in zip(reqs, fin):
        if f.rid != r.rid or len(f.tokens) != r.max_new:
            raise AssertionError(f"ha {name}: request {r.rid} got "
                                 f"{len(f.tokens)} of {r.max_new} tokens")
    if stats["pages_live_end"] != 0 or any(
            e.alloc.n_live != 1 for e in fleet.engines):
        raise AssertionError(f"ha {name}: a pool did not drain: "
                             f"{stats['pool']}")
    n_tok = sum(len(f.tokens) for f in fin)
    rec = dict(requests=len(fin), generated_tokens=n_tok, wall_s=wall,
               tok_s=n_tok / wall, decode_rounds=stats["decode_rounds"],
               decode_ms_per_round=(stats["decode_s"] * 1e3
                                    / max(1, stats["decode_rounds"])),
               prefill_s=stats["prefill_s"],
               **{k: stats[k] for k in (
                   "ha_kills", "ha_hangs", "ha_migrations",
                   "ha_migrated_swap", "ha_migrated_reingest",
                   "journal_replayed", "migrated_in", "sdc_detected",
                   "preemptions")},
               heartbeats=stats["heartbeats"],
               launches=counted[name]["launches"])
    return fin, stats, rec


def ha_parity(name, model, params, reqs, oracle, fin, vdiff) -> dict:
    """Tokens of ``fin`` against the ``oracle`` run's: equal up to each
    row's first near tie (``near_tie_check``); the agreeing count."""
    pairs = [(a, b) for o, f in zip(oracle, fin)
             for a, b in zip(o.tokens, f.tokens)]
    ties = [t for t in (near_tie_check(model, params, r, o.tokens, f.tokens,
                                       vdiff, where=f"ha {name}")
                        for r, o, f in zip(reqs, oracle, fin))
            if t is not None]
    return dict(tokens_agree=sum(a == b for a, b in pairs), of=len(pairs),
                bitwise=all(o.tokens == f.tokens
                            for o, f in zip(oracle, fin)),
                near_ties=ties)


def ha_phase(model, params, vdiff: float, seed: int = 0) -> dict:
    """Replica fault tolerance at full width: a meshless
    ``ReplicatedEngine`` of two replicas on the one card (one copy of the
    weights, a pool and block tables each, ``HA_ENGINE``) serving the
    session trace ``HA_TRACE``, in four legs:

    (a) unfailed, the oracle of (b);
    (b) replica 1 killed at its burst 2, ``migrate="reingest"``, an
        in-memory journal;
    (c) ``HA_HANG`` residents, replica 0 hung at its burst 2 and declared
        dead after 3 missed beats, ``migrate="swap"`` (CRC-carrying
        blobs), against the same fleet unfailed;
    (d) one replica with a file journal killed at burst 2 with no
        survivor, recovered by ``run_with_restarts``; a second recovery
        from a copy of the crashed journal; an unfailed one-replica run.

    Gates: every request's budget, every pool drained, the launches on
    their routes (every leg); (b) one kill, a migration, replica 1 dead,
    a ``finish`` record per request; (c) one hang, a swap migration, no
    CRC mismatch; (d) one restart, a replayed request, the file loads to
    the in-memory records, a ``finish`` per request, the two recoveries
    bitwise equal.  Tokens of (b), (c), (d) against their oracles equal
    up to a near tie (``near_tie_check`` at ``vdiff``, the verify-vs-step
    difference: a reingested row's K/V come from a prefill GEMM at other
    rows than decode's, and cuBLAS rows depend on M)."""
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.launch.engine import Request, synthetic_trace
    from repro_torch.launch.journal import RequestJournal
    from repro_torch.train.fault import ReplicaFaultPlan, run_with_restarts

    t_phase = time.perf_counter()
    reqs = synthetic_trace(*HA_TRACE, model.cfg.vocab, flavor="session")
    counted, legs, parity = {}, {}, {}
    fa, _, legs["a_unfailed"] = ha_leg("a_unfailed",
                                       ha_fleet(model, params, reqs), reqs,
                                       model, counted)

    jr = TimedJournal()
    fleet = ha_fleet(model, params, reqs, migrate="reingest", journal=jr,
                     replica_fault=ReplicaFaultPlan(replica=1, at_burst=2,
                                                    mode="kill"))
    fb, sb, legs["b_kill"] = ha_leg("b_kill", fleet, reqs, model, counted)
    if not (sb["ha_kills"] == 1 and sb["ha_migrations"] >= 1
            and sb["heartbeats"][1]["status"] == "dead"
            and jr.counts()["finish"] == len(reqs)):
        raise AssertionError(f"ha b_kill: {legs['b_kill']}, journal "
                             f"{jr.counts()}")
    legs["b_kill"]["journal"] = jr.counts()
    parity["b_vs_a"] = ha_parity("b_kill", model, params, reqs, fa, fb,
                                 vdiff)
    del fleet

    n, plen, budget = HA_HANG
    rng = np.random.RandomState(seed + 20)
    hang_reqs = [Request(rid=i, tokens=rng.randint(
        0, model.cfg.vocab, size=plen).tolist(), max_new=budget)
        for i in range(n)]
    fc0, _, legs["c_unfailed"] = ha_leg(
        "c_unfailed", ha_fleet(model, params, hang_reqs, preempt="swap"),
        hang_reqs, model, counted)
    fleet = ha_fleet(model, params, hang_reqs, preempt="swap",
                     migrate="swap", hang_patience=3,
                     replica_fault=ReplicaFaultPlan(replica=0, at_burst=2,
                                                    mode="hang"))
    # a loss's time: the victim's evacuation and the survivors' adoption
    evac = []
    evacuate, settle = fleet._evacuate, fleet._settle

    def timed_evacuate(*a, **kw):
        t0 = time.perf_counter()
        out = evacuate(*a, **kw)
        evac.append(time.perf_counter() - t0)
        return out

    def timed_settle(*a, **kw):
        t0 = time.perf_counter()
        settle(*a, **kw)
        evac[-1] += time.perf_counter() - t0

    fleet._evacuate, fleet._settle = timed_evacuate, timed_settle
    fc, sc, legs["c_hang"] = ha_leg("c_hang", fleet, hang_reqs, model,
                                    counted)
    victim = sc["replicas"][0]
    if not (sc["ha_hangs"] == 1 and sc["ha_migrated_swap"] >= 1
            and sc["sdc_detected"] == 0 and len(evac) == 1):
        raise AssertionError(f"ha c_hang: {legs['c_hang']}")
    legs["c_hang"].update(
        evacuation_ms=evac[0] * 1e3,
        migrated_bytes=victim["swap_out_bytes"],
        swap_out_s=victim["swap_out_s"], swap_crc_s=sc["swap_crc_s"],
        swap_in_bytes=sc["swap_in_bytes"], swap_in_s=sc["swap_in_s"])
    parity["c_vs_unfailed"] = ha_parity("c_hang", model, params, hang_reqs,
                                        fc0, fc, vdiff)
    del fleet

    part = reqs[:HA_REPLAY]
    tmp = tempfile.mkdtemp(prefix="ha_journal_")
    try:
        path = os.path.join(tmp, "journal.jsonl")
        crashed = os.path.join(tmp, "crashed.jsonl")
        jr = TimedJournal(path)
        fleet = ha_fleet(model, params, part, replicas=1,
                         migrate="reingest", journal=jr,
                         replica_fault=ReplicaFaultPlan(replica=0,
                                                        at_burst=2,
                                                        mode="kill"))
        attempts = []

        class Runner:
            def reset_monitors(self):
                fleet.reset_monitors()

            def run(self):
                self.res = fleet.run(part)
                attempts.append(time.perf_counter())

        def make():
            if attempts:                # the first attempt crashed
                shutil.copy(path, crashed)
                attempts.clear()
            attempts.append(time.perf_counter())
            return Runner()

        box = {}

        def supervised():
            runner, box["restarts"] = run_with_restarts(make,
                                                        max_restarts=2)
            return runner.res

        fd, sd, legs["d_restart"] = ha_leg("d_restart", fleet, part, model,
                                           counted, run=supervised)
        jr.close()
        loaded = RequestJournal.load(path)
        if not (box["restarts"] == 1 and sd["journal_replayed"] >= 1
                and len(loaded.records) == len(jr.records)
                and loaded.counts()["finish"] == len(part)):
            raise AssertionError(f"ha d_restart: restarts "
                                 f"{box['restarts']}, {legs['d_restart']}, "
                                 f"journal {loaded.counts()}")
        loaded.close()
        legs["d_restart"].update(
            restarts=box["restarts"], journal_bytes=os.path.getsize(path),
            crashed_journal_bytes=os.path.getsize(crashed),
            journal_records=len(jr.records), journal=jr.counts(),
            append_s=jr.append_s,
            append_ms_per_record=jr.append_s * 1e3 / len(jr.records),
            recovery_s=attempts[1] - attempts[0])
        del fleet
        jr2 = RequestJournal.load(crashed)
        fleet = ha_fleet(model, params, part, replicas=1,
                         migrate="reingest", journal=jr2)
        fd2, _, legs["d_recovery_2"] = ha_leg("d_recovery_2", fleet, part,
                                              model, counted)
        jr2.close()
        if [f.tokens for f in fd2] != [f.tokens for f in fd]:
            raise AssertionError("ha d: two recoveries from the same "
                                 "crashed journal gave other tokens")
        del fleet
    finally:
        shutil.rmtree(tmp)
    fd0, _, legs["d_unfailed"] = ha_leg(
        "d_unfailed", ha_fleet(model, params, part, replicas=1), part,
        model, counted)
    parity["d_vs_unfailed"] = ha_parity("d_restart", model, params, part,
                                        fd0, fd, vdiff)
    parity["d_recoveries_bitwise"] = True

    total = {}
    for c in counted.values():
        total = merge_counters(total, c)
    res = dict(queue=dict(trace=HA_TRACE, flavor="session",
                          requests=len(reqs),
                          prompts=[r.prompt_len for r in reqs],
                          budgets=[r.max_new for r in reqs]),
               engine=HA_ENGINE, hang=HA_HANG, replay=HA_REPLAY, legs=legs,
               parity=parity, vdiff=vdiff,
               phase_s=time.perf_counter() - t_phase, card=card_line(),
               **total)
    log(json.dumps({"ha": res}))
    return res


# ---------------------------------------------------------------------------
# phase 6c: sharded serving, two ranks on the one card
# ---------------------------------------------------------------------------
#: the tp phase, ``TP_RANKS`` ranks on the one card over gloo, every
#: model at full width: (a) gemma2-9b cut to 8 of its 42 layers (four
#: repeats of the local / global pattern, 5.0 GiB of bf16 weights) through
#: the paged engine, 4 slots, pages of 64, chunks of 256, on 8 requests of
#: 128-1024 prompt tokens, 16 tokens each; through ``generate`` on two
#: ragged rows of ``TP_ROWS`` tokens, ``TP_GEN`` each: (b)
#: qwen3-moe-30b-a3b cut to 4 of 48 layers, its 128 experts split 64 and
#: 64, (c) minicpm3-4b 8 of 62 (20 of its 40 heads a rank) and (d)
#: deepseek-v2-lite-16b 4 of 27 (the dense layer 0 and 3 MoE layers, 8
#: of 16 heads and 32 of 64 experts a rank); (e) zamba2-1.2b 8 of 38 (the
#: least depth its layout allows: one pattern repeat and the 2-layer
#: suffix, 7 Mamba2 layers and the shared block once) and xlstm-1.3b 8 of
#: 48 (7 mLSTM, 1 sLSTM) on a row of 256 and one of 128 tokens, one
#: ``generate`` call a row (recurrent mixers refuse ragged prompts)
TP_RANKS = 2
TP_LAYERS, TP_MOE_LAYERS = 8, 4
TP_MLA_LAYERS, TP_DEEPSEEK_LAYERS = 8, 4
TP_ZAMBA2_LAYERS, TP_XLSTM_LAYERS = 8, 8
TP_PROMPTS = (1024, 128, 512, 768, 256, 896, 384, 640)
TP_GEN = 16
TP_ROWS = (96, 48)
TP_RECURRENT_PROMPTS = (256, 128)
#: tokens of the ``moe_block`` probe on the first MoE layer's experts
TP_PROBE_TOKENS = 64
#: free memory the phase needs before its parent builds its oracles
#: (gemma2 5.0, qwen3 6.0, minicpm3 1.3, deepseek 4.6, zamba2 and xlstm
#: 1.4 GiB) and the two ranks build, shard and run theirs
TP_NEED_GIB = 40.0
#: (f) the sharded fleet on a (2, 1) mesh: the (a) model and queue, 4
#: slots a row, against the meshless 2-replica fleet in this process
TP_FLEET = dict(slots=4, chunk=256, page_size=64)


def tp_requests(vocab: int, seed: int = 0) -> list:
    """The tp phase's queue: ``TP_PROMPTS`` at ``ARRIVALS``, ``TP_GEN``
    tokens each."""
    import numpy as np
    from repro_torch.launch.engine import Request
    rng = np.random.RandomState(seed + 25)
    return [Request(rid=i, tokens=rng.randint(0, vocab, size=p).tolist(),
                    max_new=TP_GEN, arrival=a)
            for i, (p, a) in enumerate(zip(TP_PROMPTS, ARRIVALS))]


def _stream_gates(where, model, params, reqs, oracle, ranks, vdiff):
    """The ranks' streams bitwise each other, each against the oracle's
    equal up to a near tie; returns the near-tie records."""
    streams = [r["tokens"] for r in ranks]
    if any(s != streams[0] for s in streams[1:]):
        raise AssertionError(f"{where}: the ranks' token streams differ")
    ties = []
    for req, plain, got in zip(reqs, oracle, streams[0]):
        if len(got) != len(plain):
            raise AssertionError(f"{where}: request {req.rid} got "
                                 f"{len(got)} tokens, the oracle "
                                 f"{len(plain)}")
        rec = near_tie_check(model, params, req, plain, got, vdiff, where)
        if rec is not None:
            ties.append(rec)
    return ties


def _weights_gate(where, digest, ranks):
    if any(r["digest"] != digest for r in ranks):
        raise AssertionError(f"{where}: the ranks' weights are not the "
                             f"oracle's: {[r['digest'] for r in ranks]} "
                             f"against {digest}")


def tp_arch_oracle(arch: str, layers: int, prompts, seed: int, tag: str,
                   **cfg_kw) -> tuple:
    """The unsharded oracle of a tp case (b)-(e): ``arch`` at full width
    cut to ``layers`` (``cfg_kw``: config overrides) through ``generate``
    on ``prompts`` (one ragged batch, or one call a row for a recurrent
    stack, which refuses ragged prompts), its counters (gated by
    ``tp_counter_gates``), its expert choices (``RouteTape``) and, for
    MoE, the ``moe_block`` probe input and output; for MLA
    ``sharded_checks.mla_reads`` of layer 0; for a recurrent stack its own
    sensitivity to another order of the same sums (the prefill at half
    its chunk).  Returns the rank spec beside the oracle's results."""
    import torch
    from repro_torch.launch import sharded_checks as sc
    from repro_torch.models.paged import num_pages
    model, params = arch_model(arch, layers, 0.0, tag, seed, **cfg_kw)
    cfg = model.cfg
    recurrent = cfg.mamba is not None or cfg.mlstm is not None
    if recurrent:
        batches = [(_uniform(1, n, cfg.vocab, seed + 28 + i).cpu(), None)
                   for i, n in enumerate(prompts)]
        rule = strip_rule(cfg, 1, [n + TP_GEN for n in prompts])
    else:
        toks, lens = _ragged(prompts, cfg.vocab, seed + 28)
        batches = [(toks.cpu(), lens.cpu())]
        rule = cluster_rule(model, len(prompts),
                            num_pages(max(prompts) + TP_GEN, cfg.page_size))
    tape = RouteTape() if cfg.moe is not None else None
    reset_attention_counters()
    ctx = tape.record() if tape is not None else contextlib.nullcontext()
    with ctx:
        t0 = time.perf_counter()
        outs = [model.generate(params, t.cuda(), gen_len=TP_GEN,
                               prompt_lens=None if n is None else n.cuda(),
                               return_logits=True) for t, n in batches]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = tp_counter_gates(f"{tag} oracle", model,
                               sc.attention_launches(), rule)
    spec = dict(arch=arch, layers=layers, seed=seed, batches=batches,
                gen_len=TP_GEN, **cfg_kw)
    res = dict(model=model, params=params, batches=batches, wall_s=wall,
               counted=counted, rule=rule,
               tokens=[g.cpu().tolist() for g, _ in outs],
               first_logits=[lg[:, 0].float().cpu() for _, lg in outs],
               digest=sc.weights_digest(params))
    if tape is not None:
        spec["routes"] = [i.cpu() for i in tape.idx]
        spec["probe_x"] = torch.randn(
            (1, TP_PROBE_TOKENS, cfg.d_model),
            generator=torch.Generator().manual_seed(seed + 27)).to(
                torch.bfloat16)
        i = next(i for i, sp in enumerate(cfg.layer_list())
                 if sp.ffn == "moe")
        res["probe"] = sc.moe_probe(params["layers"][i]["mlp"], cfg.moe,
                                    spec["probe_x"].cuda(), None, "tp_bf16",
                                    with_aux=False)
    if cfg.layer_list()[0].mixer == "mla":
        spec["mla_rows"] = list(prompts)
        res["mla_reads"] = sc.mla_reads(cfg, params["layers"][0]["attn"],
                                        list(prompts), seed=seed)
    if recurrent:
        sub = "mamba" if cfg.mamba is not None else "mlstm"
        half = model.with_cfg(**{sub: dataclasses.replace(
            getattr(cfg, sub), chunk=getattr(cfg, sub).chunk // 2)})
        sens = 0.0
        for t, _ in batches:
            t = t.cuda()
            lg, _ = model.prefill(params, t, max_len=t.shape[1] + 1)
            lh, _ = half.prefill(params, t, max_len=t.shape[1] + 1)
            sens = max(sens, float((lg - lh)[..., :cfg.vocab].abs().max()))
        res["sensitivity"] = sens
    return spec, res


def tp_counter_gates(where: str, model, c: dict, rule: set) -> dict:
    """One run's attention launch counters (``attention_launches``),
    gated for ``model``'s stack: MLA flash ``flash_tc`` at its (D, Dv) and
    no decode launch (it decodes in the absorbed form); a stack without
    attention (xlstm) none; otherwise decode ``mma`` at its group and a
    cluster size in ``rule``, flash ``flash_tc`` at (D, D)."""
    cfg = model.cfg
    kinds = {sp.mixer for sp in cfg.layer_list()}
    if "mla" in kinds:
        dims = f"{cfg.nope_dim + cfg.rope_dim}x{cfg.v_head_dim}"
        fl = c["launches"]["flash_attention"]
        if (fl <= 0 or c["launches"]["decode_attention"]
                or c["variants"]["flash_attention"]["tc"] != fl
                or c["flash_launches_by_dims"] != {dims: fl}):
            raise AssertionError(f"{where}: attention launches {c}: "
                                 f"flash_tc at {dims} only")
        return c
    if not kinds & {"gqa", "shared_attn"}:
        if any(c["launches"].values()):
            raise AssertionError(f"{where}: attention kernels launched "
                                 f"{c['launches']}, the arch has none")
        return c
    c = attention_counters(where, rule, counted=c)
    groups_gate(where, c, cfg.n_heads // cfg.n_kv_heads)
    dims = f"{cfg.head_dim}x{cfg.head_dim}"
    if set(c["flash_launches_by_dims"]) != {dims}:
        raise AssertionError(f"{where}: flash launches by dims "
                             f"{c['flash_launches_by_dims']}, all at {dims}")
    return c


def tp_arch_gates(tag: str, oracle: dict, ranks: list) -> dict:
    """The gates of a tp case (b)-(e) against its oracle
    (``tp_arch_oracle``): the ranks' weights the oracle's, their streams
    bitwise each other and the oracle's up to a near tie, first-token
    logits within ``LOGITS_TOL`` (a recurrent stack: or ``SENSITIVITY_X``
    times its own sensitivity, where that is larger), every attention
    launch on its variant and counted (``tp_counter_gates``), the MoE
    probe's routing exact and output within ``KERNEL_TOL`` of its largest
    magnitude, and for MLA each rank's heads of the prefill read bitwise
    the unsharded read's and of the absorbed decode within
    ``KERNEL_TOL``."""
    import torch
    from repro_torch.launch.engine import Request
    model, params = oracle["model"], oracle["params"]
    cfg = model.cfg
    _weights_gate(f"tp {tag}", oracle["digest"], ranks)
    mla = "mla_reads" in oracle
    total, rec = None, {}
    for r, out in enumerate(ranks):
        c = tp_counter_gates(f"tp {tag} rank {r}", model, out["counters"],
                             oracle["rule"])
        total = merge_counters(total, c)
    ldiff = max(float((a - b).abs().max()) for o in ranks
                for a, b in zip(o["first_logits"], oracle["first_logits"]))
    tol = LOGITS_TOL
    if "sensitivity" in oracle:
        tol = max(tol, SENSITIVITY_X * oracle["sensitivity"])
        rec["sensitivity"] = oracle["sensitivity"]
    if not ldiff <= tol:
        raise AssertionError(f"tp {tag}: first-token logits {ldiff} from "
                             f"the unsharded model's (tolerance {tol})")
    reqs, plain = [], []
    for b, (toks, lens) in enumerate(oracle["batches"]):
        for row in range(toks.shape[0]):
            n = toks.shape[1] if lens is None else int(lens[row])
            reqs.append(Request(rid=len(reqs), tokens=toks[row, :n].tolist(),
                                max_new=TP_GEN))
            plain.append(oracle["tokens"][b][row])
    flat = [dict(tokens=[t for b in o["tokens"] for t in b]) for o in ranks]
    ties = _stream_gates(f"tp {tag}", model, params, reqs, plain, flat,
                         ldiff)
    if "probe" in oracle:
        probe = oracle["probe"]
        for r, out in enumerate(ranks):
            p = out["probe"]
            if not (torch.equal(p["idx"], probe["idx"])
                    and torch.equal(p["dropped"], probe["dropped"])):
                raise AssertionError(f"tp {tag} rank {r}: moe_block routed "
                                     f"or dropped otherwise")
        y_err = max(float((o["probe"]["y"] - probe["y"]).abs().max())
                    for o in ranks)
        y_tol = KERNEL_TOL * float(probe["y"].abs().max())
        if not y_err <= y_tol:
            raise AssertionError(f"tp {tag}: moe_block output {y_err} from "
                                 f"the unsharded call's (tolerance {y_tol})")
        rec.update(probe_max_abs_err=y_err, probe_tol=y_tol,
                   probe_dropped=int(probe["dropped"].sum()))
    if mla:
        want = oracle["mla_reads"]
        dec_err, dec_bitwise = 0.0, True
        for r, out in enumerate(ranks):
            got, h = out["mla_reads"], out["mla_reads"]["heads"]
            mine = lambda t: t[:, r * h:(r + 1) * h]
            if not torch.equal(got["flash"], mine(want["flash"])):
                raise AssertionError(f"tp {tag} rank {r}: its heads' "
                                     f"prefill read is not bitwise the "
                                     f"unsharded read's")
            d = (got["decode"] - mine(want["decode"])).abs().max().item()
            dec_err = max(dec_err, d)
            dec_bitwise = dec_bitwise and torch.equal(got["decode"],
                                                      mine(want["decode"]))
        if not dec_err <= KERNEL_TOL:
            raise AssertionError(f"tp {tag}: the absorbed decode per head "
                                 f"{dec_err} from the unsharded one "
                                 f"(tolerance {KERNEL_TOL})")
        rec.update(heads_per_rank=ranks[0]["mla_reads"]["heads"],
                   flash_read_bitwise=True, decode_max_abs_err=dec_err,
                   decode_bitwise=dec_bitwise)
    n_tok = sum(len(t) for t in plain)
    rec.update(arch=cfg.name, layers=cfg.n_layers,
               unsharded_wall_s=oracle["wall_s"],
               unsharded_tok_s=n_tok / oracle["wall_s"],
               sharded=[dict(rank=r, wall_s=o["wall_s"],
                             tok_s=n_tok / o["wall_s"],
                             shard_gib=o["shard_gib"], **o["spmd"])
                        for r, o in enumerate(ranks)],
               first_logits_max_abs_diff=ldiff, logits_tol=tol,
               near_ties=ties, counters=total)
    return rec


def tp_fleet_oracle(model, params, reqs, journal_dir: str) -> tuple:
    """(f)'s meshless 2-replica fleet in this process, leg by leg
    (``sharded_checks.fleet_run``, journaled): unfailed, then a kill, a
    hang (swap migration) and a double loss replayed by
    ``run_with_restarts``, the bursts chosen from the unfailed leg's so
    that each plan fires mid-run.  Returns ``(legs, results)``."""
    import os
    from repro_torch.launch import sharded_checks as sc
    kw = {k: v for k, v in TP_FLEET.items() if k != "page_size"}
    run = lambda name, **leg: sc.fleet_run(
        model, params, None, reqs, replicas=2,
        journal=os.path.join(journal_dir, f"plain_{name}.jsonl"),
        **dict(kw, **leg))
    res = {"unfailed": run("unfailed")}
    b0, b1 = res["unfailed"]["bursts"]
    k0, k1 = max(1, b0 // 3), max(2, b1 // 2)
    legs = {"unfailed": {},
            "kill": dict(faults=((0, k0, "kill"),), migrate="reingest"),
            "hang": dict(faults=((0, k0, "hang"),), preempt="swap",
                         migrate="swap", hang_patience=1),
            "double": dict(faults=((0, k0, "kill"), (1, k1, "kill")),
                           migrate="reingest", restarts=2)}
    for name, leg in legs.items():
        if name != "unfailed":
            res[name] = run(name, **leg)
    ha = {n: r["ha"] for n, r in res.items()}
    if (ha["kill"]["ha_kills"] != 1 or ha["hang"]["ha_hangs"] != 1
            or ha["hang"]["ha_migrated_swap"] < 1
            or res["double"]["restarts"] != 1
            or res["double"]["tokens"] != res["unfailed"]["tokens"]):
        raise AssertionError(f"tp fleet: the meshless legs did not fail as "
                             f"planned (bursts {b0}, {b1}; {ha})")
    return legs, res


def tp_fleet_gates(oracle: dict, ranks: list, rule: set) -> dict:
    """(f)'s gates, leg by leg: every rank's streams, schedule,
    heartbeats and ``ha_*`` counters the meshless fleet's, the journal
    written by rank 0 byte for byte the meshless fleet's, every
    attention launch on its variant (decode ``mma`` at group 2 at a
    cluster size in ``rule``, flash ``flash_tc`` at (256, 256))."""
    total, legs = None, {}
    for name, want in oracle.items():
        for r, out in enumerate(ranks):
            got, where = out[name], f"tp fleet {name} rank {r}"
            for k in ("tokens", "schedule", "heartbeats", "ha", "restarts"):
                if got[k] != want[k]:
                    raise AssertionError(f"{where}: {k} {got[k]} is not the "
                                         f"meshless fleet's {want[k]}")
            c = attention_counters(where, rule, counted=got["counters"])
            groups_gate(where, c, 2)
            if set(c["flash_launches_by_dims"]) != {"256x256"}:
                raise AssertionError(f"{where}: flash launches by dims "
                                     f"{c['flash_launches_by_dims']}")
            total = merge_counters(total, c)
        if ranks[0][name]["journal"] != want["journal"]:
            raise AssertionError(f"tp fleet {name}: rank 0's journal is "
                                 f"not the meshless fleet's, byte for byte")
        legs[name] = dict(
            meshless_wall_s=want["wall_s"],
            sharded_wall_s=[o[name]["wall_s"] for o in ranks],
            ha=want["ha"], heartbeats=want["heartbeats"],
            restarts=want["restarts"], journal_bytes=len(want["journal"]),
            evacuate_ms=[o[name]["migration"]["evacuate_ms"] for o in ranks],
            migrated_bytes=[o[name]["migration"]["migrated_bytes"]
                            for o in ranks],
            spmd=[o[name]["spmd"] for o in ranks])
    return dict(legs=legs, counters=total)


def tp_phase(seed: int = 0) -> dict:
    """Sharded serving on one card: ``TP_RANKS`` ranks joined by gloo (NCCL
    refuses two ranks on one GPU), each on its head / vocab / expert
    shards, the hand-written kernels on its heads.  This proves the
    sharded code on the card; it is not a speed of NCCL tensor
    parallelism.

    (a) gemma2-9b, ``TP_LAYERS`` layers, tensor parallel through
        ``ContinuousEngine(mesh=)`` on ``tp_requests``, against the same
        queue through the unsharded engine in this process: the ranks'
        streams bitwise each other and equal to the oracle's up to a near
        tie (``near_tie_check`` at the first-token logit difference), the
        first-token logits of request 0 within ``LOGITS_TOL``, one
        layer's decode and prefill reads bitwise per head under the
        pinned split (``sharded_checks.attend_reads``), and on each rank
        decode launches ``mma`` at group 2 and at the unsharded call's
        cluster size, flash ``flash_tc`` at (256, 256).
    (b)-(e) through ``generate(mesh=)`` (``tp_arch_oracle`` /
        ``tp_arch_gates``; streams as (a), every launch gated by
        ``tp_counter_gates``): (b) qwen3-moe, ``TP_MOE_LAYERS`` layers,
        expert parallel with the oracle's expert choices (``RouteTape``),
        and ``moe_block`` on its first MoE layer against the unsharded
        call (router indices and the dropped set exact, the output within
        ``KERNEL_TOL`` of its largest magnitude); (c) minicpm3-4b and (d)
        deepseek-v2-lite (experts pinned, probed as (b)) on rows of 96
        and 48 tokens, each rank's heads of the (D, Dv) prefill read
        bitwise the unsharded read's and of the absorbed decode within
        ``KERNEL_TOL``; (e) zamba2-1.2b and xlstm-1.3b on a row of 256
        and one of 128 tokens, first-token logits within ``LOGITS_TOL``
        or ``SENSITIVITY_X`` times the model's own chunk sensitivity.
    (f) the sharded fleet on a ``(TP_RANKS, 1)`` mesh (``card_fleet``):
        (a)'s model and queue, ``TP_FLEET`` engines, four journaled legs
        (unfailed, kill, hang with swap migration, a double loss replayed
        by ``run_with_restarts``), each held to the meshless 2-replica
        fleet in this process (``tp_fleet_oracle`` / ``tp_fleet_gates``):
        streams, schedule, heartbeats, ``ha_*`` and the journal's bytes.

    Each rank builds the weights from the oracle's seed (their digest
    must be the oracle's), and returns its launch counters (set to 0 just
    before its run, read just after), its collective count and time and
    the bytes gloo staged through pinned host memory."""
    import torch
    from repro_torch.launch import sharded_checks as sc
    from repro_torch.launch import spmd
    from repro_torch.launch.engine import ContinuousEngine
    from repro_torch.models.paged import num_pages

    free_memory_gate("tp", TP_NEED_GIB)
    t_phase = time.perf_counter()
    model, params = arch_model("gemma2-9b", TP_LAYERS, 0.0, "tp", seed,
                               paged_kv=True, page_size=64)
    cfg = model.cfg
    reqs = tp_requests(cfg.vocab, seed)
    warm = [dataclasses.replace(reqs[1], max_new=2)]
    max_len = max(r.prompt_len + r.max_new for r in reqs)
    slots, chunk = 4, 256
    rule = cluster_rule(model, slots, num_pages(max_len, 64))
    eng = ContinuousEngine(model, params, slots=slots, max_len=max_len,
                           chunk=chunk)
    eng.run(warm)
    fin, st, wall, counted = engine_run(eng, reqs, "tp oracle", rule,
                                        "256x256")
    groups_gate("tp oracle", counted, 2)
    oracle = [list(f.tokens) for f in fin]
    lg0 = model.prefill(params, torch.tensor([reqs[0].tokens], device="cuda"),
                        max_len=reqs[0].prompt_len + 1)[0][0, -1].float().cpu()
    reads = sc.attend_reads(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    digest = sc.weights_digest(params)

    # (b)-(e) through generate; (f): the meshless fleet
    arch_specs, arch_oracles = {}, {}
    for tag, arch, layers, prompts, cfg_kw in (
            ("qwen3", "qwen3-moe-30b-a3b", TP_MOE_LAYERS, TP_ROWS,
             dict(paged_kv=True, page_size=64)),
            ("minicpm3", "minicpm3-4b", TP_MLA_LAYERS, TP_ROWS, {}),
            ("deepseek", "deepseek-v2-lite-16b", TP_DEEPSEEK_LAYERS, TP_ROWS,
             {}),
            ("zamba2", "zamba2-1.2b", TP_ZAMBA2_LAYERS,
             TP_RECURRENT_PROMPTS, {}),
            ("xlstm", "xlstm-1.3b", TP_XLSTM_LAYERS, TP_RECURRENT_PROMPTS,
             {})):
        arch_specs[tag], arch_oracles[tag] = tp_arch_oracle(
            arch, layers, prompts, seed, f"tp {tag}", **cfg_kw)
    journal_dir = tempfile.mkdtemp(prefix="tp-fleet-")
    fleet_legs, fleet_oracle = tp_fleet_oracle(model, params, reqs,
                                               journal_dir)

    spec = {"engine": dict(arch="gemma2-9b", layers=TP_LAYERS, seed=seed,
                           requests=reqs, slots=slots, chunk=chunk,
                           page_size=64, prompt=reqs[0].tokens, warm=warm),
            "archs": arch_specs,
            "fleet": dict(arch="gemma2-9b", layers=TP_LAYERS, seed=seed,
                          requests=reqs, legs=fleet_legs,
                          journal_dir=journal_dir, **TP_FLEET)}
    t0 = time.perf_counter()
    ranks = spmd.spawn(sc.card_rank, TP_RANKS, backend="gloo", args=(spec,),
                       timeout=600)
    spawn_s = time.perf_counter() - t0
    eng_r = [r["engine"] for r in ranks]

    # (a) gates
    _weights_gate("tp", digest, eng_r)
    total = None
    for r, out in enumerate(eng_r):
        where = f"tp rank {r}"
        c = attention_counters(where, rule, counted=out["counters"])
        groups_gate(where, c, 2)
        if set(c["flash_launches_by_dims"]) != {"256x256"}:
            raise AssertionError(f"{where}: flash launches by dims "
                                 f"{c['flash_launches_by_dims']}")
        if out["pages_live_end"] != 0:
            raise AssertionError(f"{where}: the pool did not drain")
        got = out["reads"]
        h, hk = cfg.n_heads // TP_RANKS, cfg.n_kv_heads // TP_RANKS
        for k in ("decode", "flash"):
            if not torch.equal(got[k], reads[k][:, r * h:(r + 1) * h]):
                raise AssertionError(f"{where}: its heads' {k} read is not "
                                     f"bitwise the unsharded read's")
        if got["cluster"] != reads["cluster"]:
            raise AssertionError(f"{where}: decode split {got['cluster']}, "
                                 f"the unsharded read's {reads['cluster']}")
        total = merge_counters(total, c)
    ldiff = max(float((o["first_logits"] - lg0).abs().max()) for o in eng_r)
    if not ldiff <= LOGITS_TOL:
        raise AssertionError(f"tp: first-token logits {ldiff} from the "
                             f"unsharded model's (tolerance {LOGITS_TOL})")
    ties = _stream_gates("tp", model, params, reqs, oracle, eng_r, ldiff)

    # (b)-(f) gates
    arch_res = {}
    for tag, arch_oracle in arch_oracles.items():
        arch_res[tag] = tp_arch_gates(tag, arch_oracle,
                                      [r[tag] for r in ranks])
        total = merge_counters(total, arch_res[tag].pop("counters"))
    _weights_gate("tp fleet", digest, [r["fleet"] for r in ranks])
    fleet = tp_fleet_gates(fleet_oracle, [r["fleet"] for r in ranks], rule)
    total = merge_counters(total, fleet.pop("counters"))
    shutil.rmtree(journal_dir)

    n_tok = sum(len(t) for t in oracle)
    res = dict(
        ranks=TP_RANKS, backend="gloo", layers=TP_LAYERS,
        moe_layers=TP_MOE_LAYERS, prompts=list(TP_PROMPTS), gen=TP_GEN,
        caveat="two ranks on one H100 over gloo: CUDA tensors staged "
               "through pinned host memory at every collective; not a "
               "speed of NCCL tensor parallelism",
        unsharded=dict(tok_s=n_tok / wall, wall_s=wall,
                       decode_ms_per_round=st["decode_s"] * 1e3
                       / max(1, st["decode_rounds"]),
                       decode_rounds=st["decode_rounds"]),
        sharded=[dict(rank=r, tok_s=n_tok / o["wall_s"], wall_s=o["wall_s"],
                      decode_ms_per_round=o["decode_s"] * 1e3
                      / max(1, o["decode_rounds"]),
                      decode_rounds=o["decode_rounds"],
                      shard_gib=o["shard_gib"], **o["spmd"])
                 for r, o in enumerate(eng_r)],
        first_logits_max_abs_diff=ldiff, near_ties=ties,
        read_cluster=reads["cluster"],
        rank_own_cluster=eng_r[0]["reads"]["own_cluster"],
        rank_own_split_diff=max(o["reads"]["own_split_diff"]
                                for o in eng_r),
        archs=arch_res, fleet=fleet,
        spawn_s=spawn_s, phase_s=time.perf_counter() - t_phase,
        card=card_line(), **total)
    log(json.dumps({"tp": res}))
    return res


# ---------------------------------------------------------------------------
# phase 7: flag-driven KV-precision escalation on the f32 pool
# ---------------------------------------------------------------------------
#: the escalation queue: (arrival, prompt) with a budget of 24 each;
#: request 3 refuses escalation
ESCALATION = ((0, 1024), (0, 512), (0, 256), (0, 768), (2, 384), (2, 128))
ESC_BUDGET, ESC_REFUSER = 24, 3
#: the fault plan's overflow rounds and scale, the ladder and its trigger
ESC_OVERFLOW_AT, ESC_OVERFLOW_SCALE = (3, 8), 65536.0
ESC_LADDER, ESC_OF_THRESHOLD = ("fp8", "fp16", "fp16alt"), 8


def escalation_queue(vocab: int, seed: int = 0):
    import numpy as np
    from repro_torch.launch.engine import Request
    rng = np.random.RandomState(seed + 13)
    return [Request(rid=i,
                    tokens=(rng.randint(0, 256000, size=p) % vocab).tolist(),
                    max_new=ESC_BUDGET, arrival=a,
                    no_escalate=i == ESC_REFUSER)
            for i, (a, p) in enumerate(ESCALATION)]


def escalation_engine(model, params):
    """4 slots, chunk 256, ``max_len`` 1088 (17 pages of 64), 69 pages
    (every slot's worst case plus the scratch page), the escalation
    ladder fp8 -> fp16 -> fp16alt at 8 overflow flags, and a fault plan
    scaling the K/V writes of decode rounds 3 and 8 by 65536."""
    from repro_torch.core.policy import EscalationPolicy
    from repro_torch.launch.engine import ContinuousEngine
    from repro_torch.train.fault import ServeFaultPlan
    plan = ServeFaultPlan(overflow_at=ESC_OVERFLOW_AT,
                          overflow_scale=ESC_OVERFLOW_SCALE)
    eng = ContinuousEngine(
        model, params, slots=4, max_len=1088, chunk=256, n_pages=69,
        burst_cap=8,
        fault_plan=plan, escalate=EscalationPolicy(
            ladder=ESC_LADDER, of_threshold=ESC_OF_THRESHOLD))
    return eng, plan


def escalation_schedule(fin, plan) -> dict:
    """Admit, finish and escalate rounds by rid, and each request's rung."""
    return dict(
        requests=[[f.rid, f.admit_round, f.finish_round, f.preemptions,
                   f.escalated] for f in fin],
        escalate=[[kw["round"], kw["rid"], kw["level"]]
                  for k, kw in plan.events if k == "escalate"])


def escalation_gates(fin, stats, plan, reqs, where: str) -> None:
    for r, f in zip(reqs, fin):
        if f.rid != r.rid or len(f.tokens) != r.max_new:
            raise AssertionError(f"{where}: request {r.rid} got "
                                 f"{len(f.tokens)} of {r.max_new} tokens")
    if stats["pages_live_end"] != 0:
        raise AssertionError(f"{where}: pool did not drain: {stats}")
    if stats["escalations"] < 1 or stats["esc_refused"] < 1:
        raise AssertionError(f"{where}: escalations {stats['escalations']}, "
                             f"refused {stats['esc_refused']}")
    if fin[ESC_REFUSER].escalated != 0:
        raise AssertionError(f"{where}: the refusing request escalated")
    if stats["poisoned_rounds"] or stats["nonfinite_prefill"]:
        raise AssertionError(f"{where}: non-finite logits: {stats}")
    kinds = {k for k, _ in plan.events}
    if not {"overflow", "escalate"} <= kinds:
        raise AssertionError(f"{where}: fault log {plan.events}")


#: the escalation phase's depth: 8 of gemma2-9b's 42 layers (4 repeats
#: of its local / global pair; 9.6 GiB of f32 weights, 34.4 at 42), cut
#: to pay for the gemma3, internvl2 and whisper phases and again for the
#: zamba2 and xlstm phases (PERF.md §4 has the phase times).  The
#: schedule gate holds at any depth: an injected overflow trips the
#: 8-flag threshold in one layer's write (the CPU run it is held to has 2
#: layers)
ESCALATION_LAYERS = 8


def escalation_phase(seed: int = 0) -> dict:
    """Full-width gemma2-9b under policy ``fp32`` (f32 weights and an f32
    KV pool; ``ESCALATION_LAYERS`` deep), served by the escalation engine
    (``escalation_engine``) on ``ESCALATION``: greedy, budgets of 24.
    Gates (``escalation_gates``): every request gets its budget and the
    pool drains, escalations >= 1, the refusing request refused (and ends
    at rung 0), no non-finite logits; a second run, the timed one,
    repeats the tokens and the fault plan's events; the schedule (admit /
    finish / escalate rounds by rid) equals the same queue's on the CPU at
    the reduced config; every decode launch on the fma route and every
    flash launch on the split route.  The caller frees the bf16 model
    first."""
    import torch
    from repro_torch.models.registry import build_model
    model = build_model("gemma2-9b", policy="fp32", device="cuda",
                        paged_kv=True, page_size=64,
                        n_layers=ESCALATION_LAYERS)
    t0 = time.perf_counter()
    params = model.init(seed)
    torch.cuda.synchronize()
    log(f"gemma2-9b full width under fp32, {model.cfg.n_layers} layers: "
        f"weights "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB, init "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = escalation_queue(model.cfg.vocab, seed)
    eng, plan = escalation_engine(model, params)
    reset_attention_counters()
    fin, stats = eng.run(reqs)
    counted = attention_counters(
        "escalation", cluster_rule(model, eng.slots, eng.max_pages),
        flash="split", decode="fma")
    escalation_gates(fin, stats, plan, reqs, "escalation")
    events = list(plan.events)
    sched = escalation_schedule(fin, plan)
    # the repeat run, warm (the first one also loaded the f32 paths'
    # kernels), is the timed one
    t0 = time.perf_counter()
    again, stats = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if [f.tokens for f in again] != [f.tokens for f in fin]:
        raise AssertionError("escalation: a second run gave other tokens")
    if plan.events != events:
        raise AssertionError("escalation: a second run gave other events")
    small = build_model("gemma2-9b", policy="fp32", reduced=True,
                        device="cpu", paged_kv=True,
                        page_size=model.cfg.page_size)
    cpu_reqs = escalation_queue(small.cfg.vocab, seed)
    cpu_eng, cpu_plan = escalation_engine(small, small.init(0))
    cpu_fin, cpu_stats = cpu_eng.run(cpu_reqs)
    escalation_gates(cpu_fin, cpu_stats, cpu_plan, cpu_reqs,
                     "escalation on the CPU")
    if escalation_schedule(cpu_fin, cpu_plan) != sched:
        raise AssertionError(f"escalation: the schedule differs from the "
                             f"CPU's:\n{sched}\n"
                             f"{escalation_schedule(cpu_fin, cpu_plan)}")
    # where the time goes: the first four requests, 8 tokens each
    window = [dataclasses.replace(r, max_new=8, arrival=0) for r in reqs[:4]]
    prof = profile_run(eng, window)
    n_tok = sum(len(f.tokens) for f in fin)
    res = dict(
        requests=len(fin), generated_tokens=n_tok, wall_s=wall,
        tok_s=n_tok / wall, decode_rounds=stats["decode_rounds"],
        decode_ms_per_round=(stats["decode_s"] * 1e3
                             / max(1, stats["decode_rounds"])),
        prefill_s=stats["prefill_s"],
        counters={k: stats.get(k, 0) for k in (
            "escalations", "esc_refused", "esc_deferred", "preemptions",
            "preempt_reingest", "resumed", "faults_overflow",
            "poisoned_rounds", "nonfinite_prefill")},
        events=[[k, kw] for k, kw in events if k in ("overflow", "escalate")],
        schedule=sched, schedule_equals_cpu=True, repeat_equal=True,
        card=card_line(), **counted)
    log(json.dumps({"escalation": res}))
    log(json.dumps({"where_the_time_goes_escalation": prof}))
    return res


# ---------------------------------------------------------------------------
# phase 8: MLA serving of minicpm3-4b through generate
# ---------------------------------------------------------------------------
MLA_PROMPTS = (1024, 768, 512, 256)
MLA_GEN = 32
MLA_ROPE_PROMPT = 64


def mla_counters(where: str, dims: str = "96x64") -> dict:
    """The attention launch counters since the last reset, gated for an
    MLA path: flash launched, every launch on ``flash_tc`` at ``dims``
    ("DxDv"), and no decode-kernel launch (MLA decodes in the absorbed
    form)."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    fa = flash_attention_cuda
    if fa.launches <= 0:
        raise AssertionError(f"{where}: flash_attention was not launched")
    by_dims = flash_dims()
    if fa.launches_tc != fa.launches or by_dims != {dims: fa.launches}:
        raise AssertionError(f"{where}: flash launches tc {fa.launches_tc}, "
                             f"fma {fa.launches_fma}, by dims {by_dims}: "
                             f"all must be flash_tc at {dims}")
    if decode_attention_cuda.launches:
        raise AssertionError(f"{where}: the decode kernel launched "
                             f"{decode_attention_cuda.launches} times")
    from repro_torch.launch.sharded_checks import attention_launches
    counted = attention_launches()
    q_rows_gate(where, counted)
    return dict(launches={"decode_attention": 0,
                          "flash_attention": fa.launches},
                variants={"flash_attention": {"tc": fa.launches_tc,
                                              "split": 0, "fma": 0},
                          "decode_attention": {"mma": 0, "fma": 0}},
                decode_launches_by_cluster={},
                flash_launches_by_dims=by_dims,
                **{k: counted[k] for k in ("flash_launches_by_q_rows",
                                           "flash_picks_by_q_rows",
                                           "tuned_picks")})


def _mla_rope_check(model, params, prompt) -> dict:
    """One prompt [n] through ``prefill`` (expanded form, the flash kernel)
    and token by token through ``decode_step`` (absorbed form, every key
    rotated at its own position as it is written): the last-position
    logits within ``LOGITS_TOL`` and the same greedy token unless at a
    near tie.  A prefill whose prompt keys missed their rotation (the JAX
    package's) would fail it.  A MoE model's decode pass takes the
    prefill's expert choices (``RouteTape.replay``); its free-routing
    difference is reported."""
    toks = prompt[None]
    n = toks.shape[1]
    tape = _tape(model)
    with _recording(tape):
        lg_p, _ = model.prefill(params, toks, max_len=n)

    def by_token():
        caches = model.init_caches(1, n)
        for i in range(n):
            lg, caches = model.decode_step(params, toks[:, i:i + 1], caches,
                                           i)
        return lg
    routing = {}
    if tape is not None:
        routing["free_routing_logits_max_abs_err"] = (
            lg_p - by_token()).abs().max().item()
        with tape.replay(steps_of=len(tape.idx)):
            lg_d = by_token()
    else:
        lg_d = by_token()
    if not (lg_p.isfinite().all() and lg_d.isfinite().all()):
        raise AssertionError("mla rope check: logits are not finite")
    err = (lg_p - lg_d).abs().max().item()
    top2 = lg_d[0, -1].topk(2).values
    margin = (top2[0] - top2[1]).item()
    same = int(lg_p[0, -1].argmax()) == int(lg_d[0, -1].argmax())
    res = dict(prompt=n, logits_max_abs_err=err, logits_tol=LOGITS_TOL,
               logits_absmax=lg_d[..., :model.cfg.vocab].abs().max().item(),
               same_token=same,
               decode_top2_margin=margin, **routing)
    if not err <= LOGITS_TOL:
        raise AssertionError(f"mla rope check: prefill and token-by-token "
                             f"decode logits differ by {err}")
    if not same and margin > 2 * err:
        raise AssertionError(f"mla rope check: greedy tokens differ at a "
                             f"top-2 margin {margin} > 2 x {err}")
    return res


def mla_phase(seed: int = 0) -> dict:
    """minicpm3-4b at full width under ``tp_bf16`` (random weights from
    ``seed``), served by ``Model.generate`` from its contiguous latent
    cache: 4 right-padded ragged prompts (``MLA_PROMPTS``), ``MLA_GEN``
    greedy tokens (``mla_generate``, flash at (96, 64))."""
    return mla_generate("minicpm3-4b", "96x64", "mla", seed=seed,
                        layers=MLA_LAYERS)


def mla_generate(arch: str, dims: str, tag: str, layers: int,
                 seed: int = 0, need_gib: float = 0.0,
                 classes=None) -> dict:
    """``arch`` (an MLA stack) at full width under ``tp_bf16``, ``layers``
    deep (random weights from ``seed``), served by ``Model.generate`` from its
    contiguous latent cache: 4 right-padded ragged prompts
    (``MLA_PROMPTS``), ``MLA_GEN`` greedy tokens.  Gates: the while form's
    tokens equal the scan form's; every flash launch (the expanded
    prefill) on ``flash_tc`` at ``dims`` and no decode-kernel launch
    (``mla_counters``); the prefill and first token against the plain
    versions (``_generate_vs_plain``); the rope check
    (``_mla_rope_check``).  Prefill s, decode ms per step, tok/s and the
    device's busy share over one scan call (by ``classes``)."""
    import torch
    model, params = arch_model(arch, layers, need_gib, tag, seed)
    toks, lens = _ragged(MLA_PROMPTS, model.cfg.vocab, seed + 7)
    kw = dict(gen_len=MLA_GEN, prompt_lens=lens, return_trips=True)
    model.generate(params, toks, **{**kw, "gen_len": 2})  # warm-up
    torch.cuda.synchronize()
    reset_attention_counters()
    tape = _tape(model)
    t0 = time.perf_counter()
    with _recording(tape):
        first = model.generate(params, toks, **{**kw, "gen_len": 1},
                               return_logits=True)     # prefill + token 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    scan, _, trips_scan = model.generate(params, toks, loop="scan", **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    whl, _, trips_while = model.generate(params, toks, loop="while", **kw)
    torch.cuda.synchronize()
    counted = mla_counters(tag, dims)
    if not torch.equal(scan, whl) or trips_scan != trips_while:
        raise AssertionError(f"{tag}: the while form's tokens differ from "
                             f"the scan form's")
    where = device_profile(
        lambda: model.generate(params, toks, loop="scan", **kw), t2 - t1,
        classes)
    plain = _generate_vs_plain(model, params, toks, kw, first, penalties={},
                               tape=tape)
    rope = _mla_rope_check(model, params, toks[0, :MLA_ROPE_PROMPT])
    n_tok = len(MLA_PROMPTS) * MLA_GEN
    res = dict(arch=arch, prompts=list(MLA_PROMPTS),
               gen_len=MLA_GEN, prefill_s=t1 - t0, scan_s=t2 - t1,
               decode_ms_per_step=(t2 - t1 - (t1 - t0)) * 1e3
               / (MLA_GEN - 1), tok_s=n_tok / (t2 - t1), trips=trips_scan,
               greedy_heads=scan[:, :8].tolist(), plain_vs_kernel=plain,
               rope_check=rope, card=card_line(), where_the_time_goes=where,
               **counted)
    log(json.dumps({tag: res}))
    return res


def free_memory_gate(where: str, need_gib: float) -> None:
    """Logs the card's free memory before a phase builds its model, and
    fails the phase (never skips it) when less than ``need_gib`` is
    free."""
    import torch
    free, total = torch.cuda.mem_get_info()
    log(f"{where}: {free / 2**30:.1f} GiB free of {total / 2**30:.1f} GiB "
        f"before init")
    if free < need_gib * 2**30:
        raise AssertionError(f"{where}: {free / 2**30:.1f} GiB free on the "
                             f"card, the phase needs {need_gib} GiB")


# ---------------------------------------------------------------------------
# phase 9: Mixture-of-Experts serving
# ---------------------------------------------------------------------------
#: device-time classes of the MoE phases: the dispatch's sort /
#: searchsorted / scatter / gather kernels (the router's top-k gather and
#: the few index kernels of the attention wrappers and the embedding land
#: here too) beside the kernel classes of the other phases
MOE_CLASSES = KERNEL_CLASSES + (
    ("moe_dispatch", ("sort", "searchsorted", "index", "scatter",
                      "gather")),)
#: the depths the smoke runs the MLA and MoE models at (minicpm3 62,
#: deepseek-v2-lite 27, qwen3-moe 48 layers): half of each to keep the
#: smoke well inside its limit on the slower hosts (at full depth, with
#: the train phase, its phases summed to 1199 s on an H100 80GB HBM3 at
#: 700 W), qwen3-moe a third beside the gemma3, internvl2 and whisper
#: phases, and beside the zamba2 and xlstm phases minicpm3 16, deepseek
#: 7 (its dense layer and 6 MoE layers) and qwen3-moe 8; the launchers
#: serve all
MLA_LAYERS, DEEPSEEK_LAYERS, MOE_LAYERS = 16, 7, 8
#: free device memory the two MoE phases need before their init: weights
#: (deepseek-v2-lite 15.5 GiB, qwen3-moe 20.0 GiB in bf16 at those
#: depths) and room for the padded [E, C, D] expert slabs of a
#: 4096-token prefill
DEEPSEEK_NEED_GIB = 22.0
QWEN3_NEED_GIB = 38.0


def deepseek_phase(seed: int = 0) -> dict:
    """deepseek-v2-lite-16b at full width under ``tp_bf16`` (27 layers: MLA
    with QK head dim 192 and V head dim 128, layer 0 dense, 26 MoE layers
    of 64 routed experts top-6 plus 2 shared), served by ``Model.generate``
    on ``MLA_PROMPTS`` (``mla_generate``): every flash launch ``flash_tc``
    at (192, 128), none ``flash_fma``."""
    return mla_generate("deepseek-v2-lite-16b", "192x128", "deepseek",
                        seed=seed, need_gib=DEEPSEEK_NEED_GIB,
                        classes=MOE_CLASSES, layers=DEEPSEEK_LAYERS)


def moe_model(seed: int = 0):
    """qwen3-moe-30b-a3b at full width under ``tp_bf16``, paged in 64-token
    pages, random weights from ``seed``, ``MOE_LAYERS`` of its 48 layers
    (20.0 GiB)."""
    return arch_model("qwen3-moe-30b-a3b", MOE_LAYERS, QWEN3_NEED_GIB, "moe",
                      seed, paged_kv=True, page_size=64)


def engine_run(eng, reqs, where: str, rule: set,
               dims: str = "128x128") -> tuple:
    """One timed engine run after a counter reset, gated: every request
    gets its budget, the pool drains, every decode launch on ``mma`` at a
    size in ``rule``, every flash launch ``flash_tc`` at ``dims``.
    Returns ``(fin, stats, wall, counters)``."""
    import torch
    reset_attention_counters()
    t0 = time.perf_counter()
    fin, stats = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = attention_counters(where, rule)
    if set(counted["flash_launches_by_dims"]) != {dims}:
        raise AssertionError(f"{where}: flash launches by dims "
                             f"{counted['flash_launches_by_dims']}")
    for f, r in zip(fin, reqs):
        if len(f.tokens) != r.max_new:
            raise AssertionError(f"{where}: request {f.rid} got "
                                 f"{len(f.tokens)} of {r.max_new} tokens")
    if stats["pages_live_end"] != 0:
        raise AssertionError(f"{where}: pool did not drain: {stats}")
    return fin, stats, wall, counted


#: rows of the MoE layer probe: a decode round of the 4 slots, a verify
#: chunk of 4 slots x (SPEC_K + 1) positions, a 256-token prefill chunk
MOE_PROBE_ROWS = (4, 16, 256)


def moe_layer_probe(model, params, rows=MOE_PROBE_ROWS, reps: int = 10,
                    seed: int = 0) -> list:
    """One MoE layer's FFN (``moe.moe_block``, layer 0's weights, the aux
    loss off as in serving) at each of ``rows`` tokens, ``reps`` calls in
    a row: host-clock ms per call (ending in a synchronise), device ms per
    call by class under ``torch.profiler``, the experts the tokens route
    to, and the bound of the work as laid out (every expert's weights read
    once, the padded [E, C, D] slabs' FLOPs) beside that of the routed
    experts' weights alone.  Times the layers, it says how much of a
    round the expert GEMMs take."""
    import torch
    from repro_torch.models import moe
    cfg, pol = model.cfg.moe, model.policy
    p = params["layers"][0]["mlp"]
    d, e, f = model.cfg.d_model, cfg.n_experts, cfg.d_expert
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for t in rows:
        x = torch.randn((1, t, d), generator=gen, device="cuda").to(
            p["w_gate"].dtype)

        def run():
            for _ in range(reps):
                moe.moe_block(x, p, cfg, pol, with_aux=False)
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = device_profile(run, wall, MOE_CLASSES)
        live = int(moe.route(x[0], p["router"], cfg)[2].unique().numel())
        cap = moe._capacity(t, cfg)
        w_bytes = 3 * d * f * p["w_gate"].element_size()
        flops = 2 * 3 * e * cap * d * f
        per = lambda sec: sec * 1e3 / reps
        out.append(dict(
            rows=t, capacity=cap, experts_live=live,
            wall_ms=per(wall), device_ms=per(prof["device_busy_s"]),
            device_ms_by_class={k: per(v) for k, v in
                                prof["device_s_by_class"].items()},
            bound_ms=max(e * w_bytes / HBM_BYTES_S,
                         flops / BF16_FLOP_S) * 1e3,
            routed_bytes_bound_ms=live * w_bytes / HBM_BYTES_S * 1e3,
            top_kernels=prof["top_kernels"][:4]))
    return out


def kv8_window(model, params, warm, window, fin, max_len, where) -> tuple:
    """``window`` through a fresh engine on the ``tp_bf16_kv8`` pool (fp8
    K/V) after a warm-up on ``warm``, gated by ``engine_run``; returns its
    record (first tokens compared with ``fin``'s bf16 run) and
    counters."""
    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.launch.engine import ContinuousEngine
    kv8 = dataclasses.replace(model, policy=get_policy("tp_bf16_kv8"))
    eng8 = ContinuousEngine(kv8, params, slots=4, max_len=max_len,
                            chunk=256)
    if eng8.caches[0].k_pool.dtype != torch.float8_e5m2:
        raise AssertionError(f"{where} kv8: pool dtype "
                             f"{eng8.caches[0].k_pool.dtype}")
    eng8.run(warm)
    fin8, st8, wall8, c8 = engine_run(eng8, window, f"{where} kv8",
                                      cluster_rule(kv8, eng8.slots,
                                                   eng8.max_pages))
    rec = dict(requests=len(window), max_new=window[0].max_new,
               wall_s=wall8,
               decode_ms_per_round=(st8["decode_s"] * 1e3
                                    / max(1, st8["decode_rounds"])),
               decode_rounds=st8["decode_rounds"],
               first_tokens_as_bf16=sum(f8.tokens[0] == f.tokens[0]
                                        for f8, f in zip(fin8, fin[:4])))
    log(json.dumps({f"{where}_kv8": dict(rec, **c8)}))
    return rec, c8


def moe_phase(seed: int = 0) -> dict:
    """qwen3-moe-30b-a3b at full width (``moe_model``) served by
    ``ContinuousEngine`` (4 slots, chunk 256, pages of 64) on the slice's
    queue (``PROMPTS`` at ``ARRIVALS``, ``GEN`` tokens).  Gates
    (``engine_run``): budgets, the pool drains, decode on ``mma`` at the
    cluster size ``kernels.ops`` picks, flash on ``flash_tc`` at (128,
    128).  A profiled window (the first four requests, 8 tokens) gives
    device time by class with ``moe_dispatch``; ``moe_layer_probe`` times
    one layer's FFN at a decode round's, a verify chunk's and a prefill
    chunk's rows.  Request 2 (512 tokens) again on the plain versions:
    first-token logits within ``LOGITS_TOL`` with the plain pass's expert
    choices pinned to the kernel pass's (``RouteTape``; the free-routing
    difference and the flipped choices are reported), the same first
    token, greedy tokens equal up to a near tie (``near_tie_check`` at
    the free difference).  A short run under ``tp_bf16_kv8`` (the fp8
    pool) on that window.  One speculative run on that window (``spec_k``
    3, a 1-repeat draft: 1 of ``MOE_LAYERS`` layers): streams equal the plain run's
    up to a near tie, ``0 < spec_accept_rate <= 1``, every decode launch
    (draft steps and verify folds) at its cluster size; its wall time
    against the plain engine's on the same window (``vs_plain``)."""
    import torch
    from repro_torch.launch.engine import ContinuousEngine, Request

    model, params = moe_model(seed)
    reqs = slice_requests(model, seed)
    window = [dataclasses.replace(r, max_new=min(8, GEN), arrival=0)
              for r in reqs[:4]]
    # warm-ups: the window's requests cut to 256 prompt tokens, 2 new ones
    warm = [dataclasses.replace(r, tokens=r.tokens[:256], max_new=2)
            for r in window]
    max_len = max(p + GEN for p in PROMPTS)
    eng = ContinuousEngine(model, params, slots=4, max_len=max_len,
                           chunk=256)
    eng.run(warm)
    rule = cluster_rule(model, eng.slots, eng.max_pages)
    fin, stats, wall, counted = engine_run(eng, reqs, "moe", rule)
    n_tok = sum(len(f.tokens) for f in fin)
    res = dict(arch="qwen3-moe-30b-a3b", requests=len(fin),
               prompt_tokens=sum(PROMPTS), generated_tokens=n_tok,
               wall_s=wall, prefill_ms=stats["prefill_s"] * 1e3,
               decode_ms_per_round=(stats["decode_s"] * 1e3
                                    / max(1, stats["decode_rounds"])),
               decode_rounds=stats["decode_rounds"], tok_s=n_tok / wall,
               peak_live_pages=stats["peak_live_pages"], max_len=max_len)
    log(json.dumps({"moe_serve": dict(res, **counted)}))
    t0 = time.perf_counter()
    eng.run(window)
    torch.cuda.synchronize()
    res["where_the_time_goes"] = dict(
        requests=len(window), max_new=window[0].max_new,
        **device_profile(lambda: eng.run(window), time.perf_counter() - t0,
                         MOE_CLASSES))
    log(json.dumps({"moe_where_the_time_goes": res["where_the_time_goes"]}))
    del eng
    res["layer_probe"] = moe_layer_probe(model, params, seed=seed)
    log(json.dumps({"moe_layer_probe": res["layer_probe"]}))

    # request 2 again through the plain versions
    pick = PROMPTS.index(512)
    req = reqs[pick]
    n = len(req.tokens)
    plain = model.with_cfg(decode_backend="plain", prefill_backend="plain")
    toks = torch.tensor([req.tokens], device=model.device)
    tape, free = RouteTape(), RouteTape()
    with tape.record():
        lg_k, _ = model.prefill(params, toks, max_len=n + GEN)
    with free.record():
        lg_f, _ = plain.prefill(params, toks, max_len=n + GEN)
    with tape.replay():
        lg_p, _ = plain.prefill(params, toks, max_len=n + GEN)
    if not (torch.isfinite(lg_k).all() and torch.isfinite(lg_p).all()):
        raise AssertionError("moe: first-token logits are not finite")
    lerr = (lg_k - lg_p).abs().max().item()
    free_err = (lg_k - lg_f).abs().max().item()
    solo = ContinuousEngine(plain, params, slots=1, max_len=n + GEN,
                            chunk=256)
    (fin_p,), _ = solo.run([Request(rid=0, tokens=req.tokens, max_new=GEN)])
    del solo
    tie = near_tie_check(model, params, req, fin_p.tokens, fin[pick].tokens,
                         free_err)
    top2 = lg_p[0, -1].topk(2).values
    res["plain_vs_kernel"] = dict(
        request=pick, prompt=n, logits_max_abs_err=lerr,
        logits_tol=LOGITS_TOL,
        logits_absmax=lg_k[..., :model.cfg.vocab].abs().max().item(),
        free_routing_logits_max_abs_err=free_err,
        route_flips=tape.flips(free),
        route_choices=sum(int(i.shape[0]) for i in tape.idx),
        plain_top2_margin=(top2[0] - top2[1]).item(),
        first_token_agree=fin[pick].tokens[0] == fin_p.tokens[0],
        greedy_tokens_agree=sum(a == b for a, b in zip(fin[pick].tokens,
                                                       fin_p.tokens)),
        of=GEN, near_tie=tie)
    log(json.dumps({"moe_plain_vs_kernel": res["plain_vs_kernel"]}))
    if not lerr <= LOGITS_TOL:
        raise AssertionError(f"moe: first-token logits differ by {lerr}")
    if not res["plain_vs_kernel"]["first_token_agree"]:
        raise AssertionError("moe: the first generated token differs "
                             "between the kernel path and the plain path")

    res["kv8"], c8 = kv8_window(model, params, warm, window, fin, max_len,
                                "moe")
    counted = merge_counters(counted, c8)

    # speculative: a 1-repeat draft (one layer)
    vs = verify_vs_step(model, params, seed)
    log(json.dumps({"moe_verify_vs_step": vs}))
    spec = ContinuousEngine(model, params, slots=4,
                            max_len=max_len + SPEC_K, chunk=256,
                            spec_k=SPEC_K, draft_repeats=1)
    spec.run(warm)
    srule = cluster_rule(model, spec.slots, spec.max_pages)
    fin_s, st_s, wall_s, c_s = engine_run(spec, window, "moe speculative",
                                       srule)
    rate = st_s["spec_accept_rate"]
    if not 0.0 < rate <= 1.0:
        raise AssertionError(f"moe speculative: accept rate {rate}")
    streams = {f.rid: f.tokens for f in fin}
    ties = [t for t in (near_tie_check(model, params, r, streams[r.rid],
                                       f.tokens, vs["logits_max_abs_diff"])
                        for r, f in zip(window, fin_s)) if t is not None]
    n_s = sum(len(f.tokens) for f in fin_s)
    plain_window = res["where_the_time_goes"]["wall_s"]
    res["speculative"] = dict(
        spec_k=SPEC_K, draft_repeats=1, requests=len(window),
        max_new=window[0].max_new, tok_s=n_s / wall_s, wall_s=wall_s,
        ms_per_round=st_s["decode_s"] * 1e3 / max(1, st_s["decode_rounds"]),
        decode_rounds=st_s["decode_rounds"], spec_rounds=st_s["spec_rounds"],
        spec_emitted=st_s["spec_emitted"], spec_accept_rate=rate,
        plain_window_s=plain_window, vs_plain=plain_window / wall_s,
        near_ties=ties,
        verify_vs_step=vs,
        decode_launches_by_cluster=c_s["decode_launches_by_cluster"])
    log(json.dumps({"moe_speculative": res["speculative"]}))
    counted = merge_counters(counted, c_s)
    del spec
    res.update(card=card_line(), **counted)
    log(json.dumps({"moe": {k: v for k, v in res.items()
                            if k not in ("speculative", "kv8",
                                         "where_the_time_goes",
                                         "plain_vs_kernel",
                                         "layer_probe")}}))
    return res


# ---------------------------------------------------------------------------
# phase 11: granite-20b (MQA, group 48) through the paged engine
# ---------------------------------------------------------------------------
#: layers of the granite phase: 13 of 52 (the pattern is one layer), cut
#: to keep the whole smoke inside its time limit beside the other phases
#: (PERF.md §4 has the phase times);
#: ``python -m repro_torch.launch.serve --arch granite-20b --full
#: --continuous`` serves all 52
GRANITE_LAYERS = 13
#: free device memory the granite phase needs before its init: 19.2 GiB
#: of bf16 weights at 26 layers (10.0 at 13), the KV pools (one KV head:
#: 512 bytes a token a layer) and a 256-token chunk's activations at d_ff
#: 24576
GRANITE_NEED_GIB = 24.0
#: the granite group every decode launch of the phase must run at
GRANITE_GROUP = 48


def arch_model(arch: str, layers: int, need_gib: float, tag: str,
               seed: int = 0, **cfg):
    """``arch`` at full width under ``tp_bf16`` cut to ``layers`` layers
    (None: all), random weights from ``seed``, after the free-memory
    gate; ``cfg`` overrides config fields (``paged_kv``, ``page_size``)."""
    import torch
    from repro_torch.models.registry import build_model
    free_memory_gate(tag, need_gib)
    if layers is not None:
        cfg["n_layers"] = layers
    model = build_model(arch, policy="tp_bf16", device="cuda", **cfg)
    t0 = time.perf_counter()
    params = model.init(seed)
    torch.cuda.synchronize()
    c = model.cfg
    log(f"{arch} full width: {c.n_layers} layers, d_model {c.d_model}, "
        f"{c.n_heads} heads on {c.n_kv_heads} KV heads of {c.head_dim}, "
        f"d_ff {c.d_ff}, vocab {c.vocab}, weights "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB, init "
        f"{time.perf_counter() - t0:.1f} s")
    return model, params


def granite_model(seed: int = 0, layers: int = GRANITE_LAYERS):
    """granite-20b at full width under ``tp_bf16`` cut to ``layers``
    layers, paged in 64-token pages, random weights from ``seed``."""
    return arch_model("granite-20b", layers, GRANITE_NEED_GIB, "granite",
                      seed, paged_kv=True, page_size=64)


def groups_gate(where: str, counted: dict, group: int) -> None:
    """Every decode launch of a run at group ``group``."""
    by_group = counted["decode_launches_by_group"]
    if set(by_group) != {group}:
        raise AssertionError(f"{where}: decode launches by group "
                             f"{by_group}, all must be at G {group}")


def granite_phase(seed: int = 0) -> dict:
    """granite-20b at full width (``granite_model``: 48 query heads on one
    KV head of 128, a gelu MLP with biases; ``GRANITE_LAYERS`` of its 52
    layers) through ``engine_arch_phase``, with a short run under
    ``tp_bf16_kv8`` (the fp8 pool) on the profiled window, with the same
    gates."""
    model, params = granite_model(seed)
    return engine_arch_phase(model, params, "granite", GRANITE_GROUP,
                             "128x128", kv8=True, seed=seed)


def engine_arch_phase(model, params, tag: str, group: int, dims: str,
                      kv8: bool = False, seed: int = 0) -> dict:
    """``model`` (paged, 64-token pages) served by ``ContinuousEngine`` (4
    slots, chunk 256) on the slice's queue (``PROMPTS`` at ``ARRIVALS``,
    ``GEN`` tokens).  Gates (``engine_run``): budgets, the pool drains,
    every decode launch on ``mma`` at the cluster size ``kernels.ops``
    names and at group ``group``, every flash launch ``flash_tc`` at
    ``dims``.  A profiled window (the first four requests, 8 tokens)
    gives device time by class and the idle share.  Request 2 (512
    tokens) again on the plain versions: first-token logits within
    ``LOGITS_TOL``, the same first token, greedy tokens equal up to a
    near tie.  ``kv8``: the window again under ``tp_bf16_kv8``."""
    import torch
    from repro_torch.launch.engine import ContinuousEngine, Request

    arch = model.cfg.name
    reqs = slice_requests(model, seed)
    window = [dataclasses.replace(r, max_new=min(8, GEN), arrival=0)
              for r in reqs[:4]]
    warm = [dataclasses.replace(r, tokens=r.tokens[:256], max_new=2)
            for r in window]
    max_len = max(p + GEN for p in PROMPTS)
    eng = ContinuousEngine(model, params, slots=4, max_len=max_len,
                           chunk=256)
    eng.run(warm)
    rule = cluster_rule(model, eng.slots, eng.max_pages)
    fin, stats, wall, counted = engine_run(eng, reqs, tag, rule, dims)
    groups_gate(tag, counted, group)
    n_tok = sum(len(f.tokens) for f in fin)
    res = dict(arch=arch, layers=model.cfg.n_layers,
               requests=len(fin),
               prompt_tokens=sum(PROMPTS), generated_tokens=n_tok,
               wall_s=wall, prefill_ms=stats["prefill_s"] * 1e3,
               decode_ms_per_round=(stats["decode_s"] * 1e3
                                    / max(1, stats["decode_rounds"])),
               decode_rounds=stats["decode_rounds"], tok_s=n_tok / wall,
               peak_live_pages=stats["peak_live_pages"], max_len=max_len,
               weight_read_bound_ms=sum(
                   t.numel() * t.element_size() for t in _leaves(params))
               / HBM_BYTES_S * 1e3)
    log(json.dumps({f"{tag}_serve": dict(res, **counted)}))
    t0 = time.perf_counter()
    eng.run(window)
    torch.cuda.synchronize()
    res["where_the_time_goes"] = dict(
        requests=len(window), max_new=window[0].max_new,
        **device_profile(lambda: eng.run(window), time.perf_counter() - t0))
    log(json.dumps({f"{tag}_where_the_time_goes":
                    res["where_the_time_goes"]}))
    del eng

    # request 2 again through the plain versions
    pick = PROMPTS.index(512)
    req = reqs[pick]
    n = len(req.tokens)
    plain = model.with_cfg(decode_backend="plain", prefill_backend="plain")
    toks = torch.tensor([req.tokens], device=model.device)
    lg_k, _ = model.prefill(params, toks, max_len=n + GEN)
    lg_p, _ = plain.prefill(params, toks, max_len=n + GEN)
    if not (torch.isfinite(lg_k).all() and torch.isfinite(lg_p).all()):
        raise AssertionError(f"{tag}: first-token logits are not finite")
    lerr = (lg_k - lg_p).abs().max().item()
    solo = ContinuousEngine(plain, params, slots=1, max_len=n + GEN,
                            chunk=256)
    (fin_p,), _ = solo.run([Request(rid=0, tokens=req.tokens, max_new=GEN)])
    del solo
    tie = near_tie_check(model, params, req, fin_p.tokens, fin[pick].tokens,
                         lerr, where=tag)
    top2 = lg_p[0, -1].topk(2).values
    res["plain_vs_kernel"] = dict(
        request=pick, prompt=n, logits_max_abs_err=lerr,
        logits_tol=LOGITS_TOL,
        logits_absmax=lg_k[..., :model.cfg.vocab].abs().max().item(),
        plain_top2_margin=(top2[0] - top2[1]).item(),
        first_token_agree=fin[pick].tokens[0] == fin_p.tokens[0],
        greedy_tokens_agree=sum(a == b for a, b in zip(fin[pick].tokens,
                                                       fin_p.tokens)),
        of=GEN, near_tie=tie)
    log(json.dumps({f"{tag}_plain_vs_kernel": res["plain_vs_kernel"]}))
    if not lerr <= LOGITS_TOL:
        raise AssertionError(f"{tag}: first-token logits differ by {lerr}")
    if not res["plain_vs_kernel"]["first_token_agree"]:
        raise AssertionError(f"{tag}: the first generated token differs "
                             f"between the kernel path and the plain path")

    if kv8:
        res["kv8"], c8 = kv8_window(model, params, warm, window, fin,
                                    max_len, tag)
        groups_gate(f"{tag} kv8", c8, group)
        counted = merge_counters(counted, c8)
    res.update(card=card_line(), **counted)
    log(json.dumps({tag: {k: v for k, v in res.items()
                          if k not in ("kv8", "where_the_time_goes",
                                       "plain_vs_kernel")}}))
    return res


# ---------------------------------------------------------------------------
# phases 12-14: the last attention archs (gemma3, internvl2, whisper)
# ---------------------------------------------------------------------------
#: gemma3-12b's depth in the smoke: one repeat of its 5-local-1-global
#: pattern (6 of 48 layers, 4.5 GiB of bf16 weights with the 262144-row
#: embedding: both layer kinds), paid for by the cuts in
#: ``ESCALATION_LAYERS``, ``GRANITE_LAYERS`` and ``MOE_LAYERS``; two
#: repeats until the zamba2 and xlstm phases; the launchers serve all 48
GEMMA3_LAYERS = 6
GEMMA3_NEED_GIB = 14.0
#: internvl2-26b's depth: 8 of 48 layers (4.3B parameters, 8.2 GiB)
INTERNVL2_LAYERS = 8
INTERNVL2_NEED_GIB = 14.0
#: internvl2's ragged rows (each at least its 256 patch positions + text)
#: and its group (48 query heads on 8 KV heads)
INTERNVL2_PROMPTS = (1024, 768, 512, 300)
INTERNVL2_GROUP = 6
#: whisper-small runs at full depth (12 encoder + 12 decoder layers,
#: 290M parameters): 4 rows of short ragged decoder prompts, 32 tokens
WHISPER_PROMPTS = (32, 24, 16, 8)
WHISPER_NEED_GIB = 4.0
#: whisper's encoder states and cross caches, kernel path against the
#: plain path: 12 bidirectional bf16 layers of 1500 frames carry last-bit
#: differences of the attention's p rounding as the decoder's 12 layers
#: carry them into the logits (``LOGITS_TOL``); the states are
#: layer-normed (unit scale), so the same absolute bound applies
ENCODER_TOL = LOGITS_TOL


#: zamba2-1.2b at full width: 4 rows of 1000 tokens (3 whole 256-token
#: chunks and a padded fourth of 232), 32 greedy tokens; equal lengths,
#: since recurrent mixers refuse ragged prompts (as in JAX).  At full depth
#: 2.4 GiB of bf16 weights, the fp32 copy of the continuation gate 4.8
ZAMBA2_PROMPT, ZAMBA2_ROWS = 1000, 4
ZAMBA2_NEED_GIB = 12.0
#: xlstm-1.3b at full width: 4 rows of 600 tokens (2 whole mLSTM chunks
#: and a padded 88-token one; 600 sequential sLSTM steps a layer), 32
#: greedy tokens; at full depth 3.6 GiB of bf16 weights, 7.2 in fp32
XLSTM_PROMPT, XLSTM_ROWS = 600, 4
XLSTM_NEED_GIB = 20.0
#: the recurrent phases' depths: three repeats of each pattern, half of
#: each stack (zamba2 20 of 38 layers: 17 Mamba2 and 3 shared-block
#: positions; xlstm 24 of 48: 21 mLSTM and 3 sLSTM), to pay with the
#: generate phase's shorter profile for the tp phase and keep the smoke
#: near 1000 s on the slower hosts
ZAMBA2_LAYERS, XLSTM_LAYERS = 20, 24
#: the continuation gate (JAX's ``test_decode_matches_prefill_continuation``
#: invariant at full width, one row, policy ``fp32``): ``CONT_TOKENS``
#: decode steps after a prefill against the prefill of the longer prompt,
#: gated at one pattern repeat and the suffix (8 layers of each arch).
#: On the CPU (PyTorch) the last logits part by 2.1e-6 on the reduced
#: configs (prompt 40) and by 1.3e-5 (zamba2, d_model 256, 12 layers,
#: chunk 256, prompt 600) and 4.5e-6 (xlstm, d_model 256, 8 layers); on
#: an H100 by 3.1e-4 at xlstm's full width and 8 layers; ``CONT_TOL``
#: leaves ~6x over that.  A state carried wrongly (the pad, the window,
#: the stabiliser) moves the logits by O(0.1) or more
CONT_TOKENS = 8
CONT_TOL = 2e-3
#: the gates that random full-depth recurrent stacks need: they carry a
#: rounding-level change much further than gemma2's stack (on an H100,
#: zamba2's first-token logits, kernel against plain, 0.353, past
#: ``LOGITS_TOL``; xlstm's fp32 prefill at chunk 128 against 256, 1.18),
#: so such a gate is its fixed bound or this many times the model's own
#: sensitivity to the same kind of change, whichever is larger
#: (``attention_sensitivity``: plain versions against the dense path;
#: ``continuation_gate``: half the chunk)
SENSITIVITY_X = 3.0
#: the recurrent phases' profiled window: the rows cut to 16 prompt
#: tokens, 4 generated (the whole scan is ~180,000 kernel launches in
#: xlstm, 57 s under the profiler and its reading on an H100 host; 64
#: and 8 took 13.5 s)
RECURRENT_WINDOW = (16, 4)
#: device-time classes of the recurrent phases: f32-output GEMMs on CUDA
#: cores (the projections ``tp_einsum(out_fmt="fp32")`` widens to f32:
#: ``in_proj``, ``up_proj``, ``w_gates``, the state products) apart from
#: the 16-bit tensor-core GEMMs
RECURRENT_CLASSES = (
    KERNEL_CLASSES[:2]
    + (("gemm_f32", lambda low: (
        any(g in low for g in ("gemm", "gemv", "nvjet", "xmma"))
        and any(f in low for f in ("kernel<float", "f32f32_f32f32",
                                   "sgemm", "nvjet_sss")))),)
    + KERNEL_CLASSES[2:])


def arch_kernel_cases() -> tuple:
    """The gemma3, internvl2 and whisper phases' attention reads at their
    serving shapes, as ``(decode records, flash records)``; none has a
    softcap, so SDPA computes each (``library_ms``).

    gemma3-12b (16 / 8 heads of 256, group 2): decode on a local layer
    (window 1024) over the slice's 4 slots, and a 256-token chunk at
    q_offset 1792 of two 4080-token prompts, whose window drops the keys
    left of 769.  internvl2-26b (48 / 8 heads of 128, group 6: 6 live
    heads of the decode kernel's tile of 8, and 128 // 6 = 21 query
    positions of a 128-row ``flash_tc`` tile, 10 of a 64-row one): the
    generate phase's last decode step over its paged ragged rows, and its
    1024-query prefill from position 0.  whisper-small (12 heads of 64,
    group 1): the encoder's non-causal read (4 rows x 1500 x 1500), the
    cross-attention prefill (a 32-token prompt x 1500 frames, non-causal),
    decode over the contiguous 1500-frame cross cache and over the
    decoder's contiguous self cache.  zamba2-1.2b (32 heads of 64, group
    1, the shared attention block at 6 of 38 layers): the last decode
    step of the zamba2 phase (4 contiguous rows of ``ZAMBA2_PROMPT +
    GEN_LEN - 1`` keys) and its prefill (4 rows x 32 heads x
    ``ZAMBA2_PROMPT`` causal queries at (64, 64))."""
    import torch
    bf16 = torch.bfloat16
    zb = dict(window=None, softcap=None, heads=(32, 1), d=64)
    g3 = dict(window=1024, softcap=None, heads=(8, 2), d=256)
    iv = dict(window=None, softcap=None, heads=(8, INTERNVL2_GROUP), d=128)
    wh = dict(window=None, softcap=None, heads=(12, 1), d=64)
    frames = 1500
    width = max(WHISPER_PROMPTS)
    dec = [decode_case("decode_bf16_p64_gemma3", dtype=bf16, page=64,
                       kv_lens=[1056, 540, 0, 4111], alias=4, seed=30, **g3),
           decode_case("decode_bf16_p64_internvl2", dtype=bf16, page=64,
                       kv_lens=[p + GEN_LEN - 1 for p in INTERNVL2_PROMPTS],
                       alias=0, seed=31, **iv),
           decode_case("decode_bf16_whisper_cross", dtype=bf16, page=0,
                       kv_lens=[frames] * 4, strip=frames, alias=0, seed=32,
                       **wh),
           decode_case("decode_bf16_whisper_self", dtype=bf16, page=0,
                       kv_lens=[p + GEN_LEN - 1 for p in WHISPER_PROMPTS],
                       strip=width + GEN_LEN, alias=0, seed=33, **wh),
           decode_case("decode_bf16_zamba2", dtype=bf16, page=0,
                       kv_lens=[ZAMBA2_PROMPT + GEN_LEN - 1] * ZAMBA2_ROWS,
                       strip=ZAMBA2_PROMPT + GEN_LEN, alias=0, seed=38,
                       **zb)]
    fl = [flash_case("flash_bf16_p64_gemma3_chunk", dtype=bf16, page=64,
                     rows=[256, 256], q_offset=1792, chunk=256, alias=4,
                     seed=34, **g3),
          flash_case("flash_bf16_p64_internvl2", dtype=bf16, page=64,
                     rows=list(INTERNVL2_PROMPTS), q_offset=0,
                     chunk=max(INTERNVL2_PROMPTS), alias=0, seed=35,
                     pages=-(-(max(INTERNVL2_PROMPTS) + GEN_LEN) // 64),
                     main=True, **iv),
          flash_case("flash_bf16_whisper_encoder", dtype=bf16, page=0,
                     rows=[frames] * 4, q_offset=0, chunk=frames, alias=0,
                     seed=36, causal=False, main=True, **wh),
          flash_case("flash_bf16_whisper_cross", dtype=bf16, page=0,
                     rows=[frames] * 4, q_offset=0, chunk=width,
                     keys=frames, alias=0, seed=37, causal=False, **wh),
          flash_case("flash_bf16_zamba2_prefill", dtype=bf16, page=0,
                     rows=[ZAMBA2_PROMPT] * ZAMBA2_ROWS, q_offset=0,
                     chunk=ZAMBA2_PROMPT, alias=0, seed=39, **zb)]
    return dec, fl


def gemma3_phase(seed: int = 0) -> dict:
    """gemma3-12b at full width under ``tp_bf16`` (16 query heads on 8 KV
    heads of 256, window 1024 on 5 of every 6 layers, qk-norm, sandwich
    norms, no softcap; ``GEMMA3_LAYERS`` of its 48 layers), paged in
    64-token pages, through ``engine_arch_phase`` on the slice's queue:
    every decode launch at group 2, every flash launch ``flash_tc`` at
    (256, 256)."""
    model, params = arch_model("gemma3-12b", GEMMA3_LAYERS, GEMMA3_NEED_GIB,
                               "gemma3", seed, paged_kv=True, page_size=64)
    return engine_arch_phase(model, params, "gemma3", 2, "256x256",
                             seed=seed)


def _ragged(prompts, vocab: int, seed: int):
    """Right-padded prompt tokens [len(prompts), max] from ``seed`` and
    their lengths, on the card."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    toks = torch.zeros((len(prompts), max(prompts)), dtype=torch.int64)
    for r, n in enumerate(prompts):
        toks[r, :n] = torch.from_numpy(rng.randint(0, vocab, size=n))
    return toks.cuda(), torch.tensor(prompts, device="cuda")


def stream_near_ties(where: str, got, plain, plain_logits,
                     tol: float = LOGITS_TOL) -> list:
    """Greedy streams ``got`` (kernel path) against ``plain`` [B, T] (the
    plain path's, with its logits [B, T, V]): where a row first parts, the
    kernel path saw the plain path's own history, so the two candidates'
    plain logits must lie within ``2 tol`` (each path's logits within
    ``tol`` of the other's).  Returns one record a row that parts."""
    ties = []
    for r in range(got.shape[0]):
        diff = (got[r] != plain[r]).nonzero()
        if not len(diff):
            continue
        s = int(diff[0])
        a, b = int(plain[r, s]), int(got[r, s])
        gap = abs(plain_logits[r, s, a].item() - plain_logits[r, s, b].item())
        rec = dict(row=r, step=s, plain_token=a, token=b, gap=gap,
                   bound=2 * tol)
        ties.append(rec)
        if not gap <= rec["bound"]:
            raise AssertionError(f"{where}: row {r} parts from the plain "
                                 f"stream at step {s} away from a near tie: "
                                 f"{rec}")
    return ties


def generate_arch(model, params, toks, lens, tag: str, fe, rule,
                  group: int, dims: str, gen_len: int = GEN_LEN,
                  classes=None, plain_ctx=None,
                  logits_tol: float = LOGITS_TOL, window=None) -> tuple:
    """``Model.generate`` of ``toks`` (``lens`` live, or None: every row
    whole) with frontend embeddings ``fe``, greedy: a warm-up, then the
    prefill and first token alone and the whole scan, both timed after a
    counter reset and gated (``attention_counters``: every decode launch
    ``mma`` at a size in ``rule`` and at group ``group``, every flash
    launch ``flash_tc`` at ``dims``; ``rule`` None: an arch without
    attention, no attention kernel may launch); one more scan under the
    profiler, or, with ``window`` = (prompt tokens, generated tokens), a
    generate of the rows cut to that window, timed and profiled (the
    profiler reads ~0.2 ms of host time an event: a recurrent scan
    launches ~10^5 kernels).  Then the plain versions' whole scan (skipped without
    attention: it is the same computation): first-token logits within
    ``logits_tol``, streams equal up to a near tie (``stream_near_ties``),
    under ``plain_ctx`` (a context manager, e.g.
    ``EncodeTape.record()``).  Returns ``(record, counters, first-token
    logits)``."""
    import torch
    kw = dict(prompt_lens=lens, frontend_embeds=fe, return_logits=True)
    tw = time.perf_counter()
    model.generate(params, toks, gen_len=2, **kw)         # warm-up
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - tw
    reset_attention_counters()
    t0 = time.perf_counter()
    first = model.generate(params, toks, gen_len=1, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gen, lgs = model.generate(params, toks, gen_len=gen_len, **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if rule is None:
        counted = no_attention_counters(tag)
    else:
        counted = attention_counters(tag, rule)
        groups_gate(tag, counted, group)
        if set(counted["flash_launches_by_dims"]) != {dims}:
            raise AssertionError(f"{tag}: flash launches by dims "
                                 f"{counted['flash_launches_by_dims']}")
    if not torch.equal(first[0][:, 0], gen[:, 0]):
        raise AssertionError(f"{tag}: the first token of the scan differs "
                             f"from the prefill's")
    if window is None:
        where = device_profile(lambda: model.generate(
            params, toks, gen_len=gen_len, **kw), t2 - t1, classes)
    else:
        wt = toks[:, :window[0]]
        run = lambda: model.generate(params, wt, gen_len=window[1], **kw)
        t3 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        where = dict(device_profile(run, time.perf_counter() - t3, classes),
                     window=dict(prompt=window[0], gen_len=window[1]))
    if not lgs.isfinite().all():
        raise AssertionError(f"{tag}: logits are not finite")
    n_tok = gen.numel()
    rec = dict(rows=toks.shape[0],
               prompts=(lens.tolist() if lens is not None
                        else [toks.shape[1]] * toks.shape[0]),
               gen_len=gen_len, prefill_s=t1 - t0, scan_s=t2 - t1,
               decode_ms_per_step=(t2 - t1 - (t1 - t0)) * 1e3
               / (gen_len - 1), tok_s=n_tok / (t2 - t1), warmup_s=warmup_s,
               logits_absmax=lgs[..., :model.cfg.vocab].abs().max().item(),
               greedy_heads=gen[:, :8].tolist(), where_the_time_goes=where)
    if rule is None:
        return rec, counted, lgs[:, 0]
    plain = model.with_cfg(decode_backend="plain", prefill_backend="plain")
    t3 = time.perf_counter()
    with plain_ctx or contextlib.nullcontext():
        gen_p, lgs_p = plain.generate(params, toks, gen_len=gen_len, **kw)
    torch.cuda.synchronize()
    rec["plain_s"] = time.perf_counter() - t3
    if not lgs_p.isfinite().all():
        raise AssertionError(f"{tag}: the plain path's logits are not "
                             f"finite")
    lerr = (lgs[:, 0] - lgs_p[:, 0]).abs().max().item()
    rec["plain_vs_kernel"] = dict(
        logits_max_abs_err=lerr,
        logits_mean_abs_err=(lgs[:, 0] - lgs_p[:, 0])[
            ..., :model.cfg.vocab].abs().mean().item(),
        logits_tol=logits_tol, logits_absmax=rec["logits_absmax"],
        tokens_agree=int((gen == gen_p).sum()), of=n_tok)
    log(json.dumps({f"{tag}_plain_vs_kernel": rec["plain_vs_kernel"]}))
    if not lerr <= logits_tol:
        raise AssertionError(f"{tag}: first-token logits differ from the "
                             f"plain path's by {lerr}")
    rec["plain_vs_kernel"]["near_ties"] = stream_near_ties(
        tag, gen, gen_p, lgs_p, logits_tol)
    return rec, counted, lgs[:, 0]


def internvl2_phase(seed: int = 0) -> dict:
    """internvl2-26b at full width under ``tp_bf16`` (48 query heads on 8
    KV heads of 128: group 6; d_ff 16384, vocab 92553, untied;
    ``INTERNVL2_LAYERS`` of its 48 layers), paged in 64-token pages,
    through ``Model.generate``: 4 ragged rows (``INTERNVL2_PROMPTS``),
    ``GEN_LEN`` greedy tokens, seeded patch embeddings [4, 256, 6144]
    over the first 256 positions (``generate_arch``'s gates: decode at
    group 6, flash ``flash_tc`` at (128, 128)).  One more gate: other
    patch embeddings move the first-token logits by more than
    ``2 LOGITS_TOL``, so the overwrite is not dropped."""
    import torch
    model, params = arch_model("internvl2-26b", INTERNVL2_LAYERS,
                               INTERNVL2_NEED_GIB, "internvl2", seed,
                               paged_kv=True, page_size=64)
    cfg = model.cfg
    toks, lens = _ragged(INTERNVL2_PROMPTS, cfg.vocab, seed + 9)
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    patches = torch.randn((len(INTERNVL2_PROMPTS), cfg.n_frontend_tokens,
                           cfg.d_model), generator=gen,
                          device="cuda").to(torch.bfloat16)
    max_len = max(INTERNVL2_PROMPTS) + GEN_LEN
    rule = cluster_rule(model, len(INTERNVL2_PROMPTS), -(-max_len // 64))
    rec, counted, lg0 = generate_arch(model, params, toks, lens,
                                      "internvl2", patches, rule,
                                      INTERNVL2_GROUP, "128x128")
    other = torch.randn(patches.shape, generator=gen,
                        device="cuda").to(torch.bfloat16)
    lg_other = model.generate(params, toks, gen_len=1, prompt_lens=lens,
                              frontend_embeds=other,
                              return_logits=True)[1][:, 0]
    moved = (lg_other - lg0).abs().max().item()
    rec.update(arch=cfg.name, layers=cfg.n_layers,
               patch_positions=cfg.n_frontend_tokens,
               other_patches_move_logits=moved, card=card_line(), **counted)
    log(json.dumps({"internvl2": rec}))
    if not moved > 2 * LOGITS_TOL:
        raise AssertionError(f"internvl2: other patch embeddings move the "
                             f"first-token logits by {moved} only")
    return rec


def _lively_norms(params, seed: int) -> None:
    """Gains ~ 1 + 0.1 N, shifts and MLP biases ~ 0.1 N, in place: the JAX
    package's init (which the port's follows) zeroes a layernorm's gain,
    so an untrained whisper's every state, and so its logits, are 0."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def walk(t, key=None):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, k)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        elif key in ("g", "b", "b_up", "b_down"):
            n = torch.randn(t.shape, generator=gen, device=t.device) * 0.1
            t.copy_(n + 1.0 if key == "g" else n)
    walk(params)


class EncodeTape:
    """The encoder states ``models.transformer.encode`` returns while
    ``record()`` is active: the plain pass's states, taken from its own
    prefill rather than from a second walk of the plain encoder."""

    def __init__(self):
        self.states = []

    @contextlib.contextmanager
    def record(self):
        from repro_torch.models import transformer
        orig = transformer.encode

        def rec(*args, **kw):
            out = orig(*args, **kw)
            self.states.append(out)
            return out
        transformer.encode = rec
        try:
            yield self
        finally:
            transformer.encode = orig


def whisper_phase(seed: int = 0) -> dict:
    """whisper-small at full width and depth under ``tp_bf16`` (12
    encoder and 12 decoder layers, d 768, 12 heads of 64, d_ff 3072, vocab
    51865, 1500 frames, learned positions, layernorm; norms and biases
    drawn by ``_lively_norms``) through ``Model.generate``: 4 rows of
    ``WHISPER_PROMPTS``, ``GEN_LEN`` greedy tokens, seeded frame
    embeddings [4, 1500, 768] (``generate_arch``'s gates: decode at group
    1 on the contiguous self and cross caches, flash ``flash_tc`` at (64,
    64)).  Gates of its own: each prefill launches flash without the
    causal mask once a layer of the encoder and of the decoder's
    cross-attention, and causally once a decoder layer; the encoder
    states and every layer's cross cache within ``ENCODER_TOL`` of the
    plain path's (the plain states taken from the plain generate's own
    prefill, ``EncodeTape``; the cache against them projected by the
    layer's own weights: what the plain prefill writes)."""
    import torch
    from repro_torch.core import ops as tp
    model, params = arch_model("whisper-small", None, WHISPER_NEED_GIB,
                               "whisper", seed)
    _lively_norms(params, seed + 11)
    cfg, e = model.cfg, model.cfg.encoder
    b = len(WHISPER_PROMPTS)
    toks, lens = _ragged(WHISPER_PROMPTS, cfg.vocab, seed + 12)
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    frames = torch.randn((b, e.n_frames, cfg.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)
    max_len = max(WHISPER_PROMPTS) + GEN_LEN
    rule = strip_rule(cfg, b, (max_len, e.n_frames))
    tape = EncodeTape()
    rec, counted, _ = generate_arch(model, params, toks, lens, "whisper",
                                    frames, rule, 1, "64x64",
                                    plain_ctx=tape.record())
    # the two timed calls hold two prefills: 12 encoder + 12 cross
    # launches without the causal mask, 12 decoder launches with it, each
    nc = counted["flash_launches_noncausal"]
    want = (2 * (e.n_layers + cfg.n_layers), 2 * cfg.n_layers)
    got = (nc, counted["launches"]["flash_attention"] - nc)
    if got != want:
        raise AssertionError(f"whisper: flash launches (non-causal, causal) "
                             f"{got}, expected {want}")
    enc_k = model.encode(params, frames)
    enc_p = tape.states[0]
    _, caches = model.prefill(params, toks, max_len=max_len,
                              prompt_lens=lens, frontend_embeds=frames)
    xerr = 0.0
    for lp, c in zip(params["layers"], caches):
        for name, buf in (("wk", c.xkv.k), ("wv", c.xkv.v)):
            want_kv = tp.tp_matmul(enc_p, lp["xattn"][name], model.policy)
            want_kv = want_kv.reshape(b, e.n_frames, cfg.n_kv_heads,
                                      cfg.head_dim).transpose(1, 2)
            xerr = max(xerr, (buf.float() - want_kv.float()).abs().max()
                       .item())
    eerr = (enc_k.float() - enc_p.float()).abs().max().item()
    rec.update(arch=cfg.name, encoder_layers=e.n_layers,
               decoder_layers=cfg.n_layers, frames=e.n_frames,
               flash_noncausal_launches=nc,
               encoder_max_abs_err=eerr,
               encoder_absmax=enc_k.float().abs().max().item(),
               cross_cache_max_abs_err=xerr, encoder_tol=ENCODER_TOL,
               card=card_line(), **counted)
    log(json.dumps({"whisper": rec}))
    if not eerr <= ENCODER_TOL:
        raise AssertionError(f"whisper: encoder states differ from the "
                             f"plain path's by {eerr}")
    if not xerr <= ENCODER_TOL:
        raise AssertionError(f"whisper: cross caches differ from the plain "
                             f"path's by {xerr}")
    return rec


# ---------------------------------------------------------------------------
# phases 15-16: the recurrent archs (zamba2, xlstm)
# ---------------------------------------------------------------------------
def _uniform(rows: int, prompt: int, vocab: int, seed: int):
    """``rows`` prompts of ``prompt`` tokens from ``seed``, on the card."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, vocab, (rows, prompt))).cuda()


def state_bytes(model, max_len: int) -> dict:
    """One row's cache bytes: the recurrent layers' states (conv windows,
    Mamba2 / mLSTM / sLSTM states) and the attention layers' KV at
    ``max_len`` positions."""
    from repro_torch.models import ssm
    rec = kv = 0
    for c in model.init_caches(1, max_len):
        n = _nbytes(*c)
        if isinstance(c, (ssm.Mamba2Cache, ssm.MLSTMCache,
                          ssm.SLSTMCache)):
            rec += n
        else:
            kv += n
    return dict(recurrent_state_bytes_per_row=rec,
                kv_bytes_per_row=kv, max_len=max_len)


def _continuation(model, params, row, extra) -> tuple:
    """The last logits after ``row``'s prefill and ``extra``'s tokens one
    ``decode_step`` at a time, against the prefill of both: ``(max abs
    difference, |logits| max, the prefill's logits)`` over the live
    vocab."""
    import torch
    n, k = row.shape[1], extra.shape[1]
    full = torch.cat([row, extra], dim=1)
    lg_a, caches = model.prefill(params, row, max_len=n + k)
    for i in range(k):
        lg_a, caches = model.decode_step(params, full[:, n + i:n + i + 1],
                                         caches, n + i)
    lg_b, _ = model.prefill(params, full, max_len=n + k)
    v = model.cfg.vocab
    if not (lg_a.isfinite().all() and lg_b.isfinite().all()):
        raise AssertionError(f"{model.cfg.name}: continuation logits are "
                             f"not finite")
    return ((lg_a[..., :v] - lg_b[..., :v]).abs().max().item(),
            lg_b[..., :v].abs().max().item(), lg_b)


def continuation_gate(model, params, toks, tag: str, seed: int) -> dict:
    """JAX's continuation invariant at full width, one row, policy
    ``fp32`` (the same weights widened): a prefill of ``toks[:1]``, then
    ``CONT_TOKENS`` seeded tokens through ``decode_step`` one at a time,
    against the prefill of the prompt and those tokens.  Holds on the
    card that the chunked state carry, the padded last chunk and the conv
    window are right.

    Gated at one repeat of the layer pattern and the suffix (``draft_view``:
    every mixer kind of the arch), within ``CONT_TOL``; deeper, the
    randomly initialised stacks carry f32 rounding far (xlstm's 48 layers
    move the logits by O(1) between two chunk sizes), so the phase's whole
    stack is held to ``SENSITIVITY_X`` times its own sensitivity: the
    prefill at half the chunk against the prefill at the chunk."""
    import torch
    from repro_torch.core.policy import get_policy
    t0 = time.perf_counter()
    wide = dataclasses.replace(model, policy=get_policy("fp32"))
    p32 = _widen(params)
    row = toks[:1]
    extra = _uniform(1, CONT_TOKENS, model.cfg.vocab, seed)
    cut, cp, _ = wide.draft_view(p32, None, 1)
    err_cut, abs_cut, _ = _continuation(cut, cp, row, extra)
    err, absmax, lg_b = _continuation(wide, p32, row, extra)
    half = {sub: dataclasses.replace(getattr(model.cfg, sub),
                                     chunk=getattr(model.cfg, sub).chunk // 2)
            for sub in ("mamba", "mlstm") if getattr(model.cfg, sub)}
    lg_h, _ = wide.with_cfg(**half).prefill(
        p32, torch.cat([row, extra], dim=1),
        max_len=row.shape[1] + CONT_TOKENS)
    torch.cuda.synchronize()
    v = model.cfg.vocab
    sens = (lg_h[..., :v] - lg_b[..., :v]).abs().max().item()
    bound = max(CONT_TOL, SENSITIVITY_X * sens)
    rec = dict(policy="fp32", prompt=row.shape[1], steps=CONT_TOKENS,
               one_repeat=dict(layers=cut.cfg.n_layers,
                               logits_max_abs_err=err_cut, tol=CONT_TOL,
                               logits_absmax=abs_cut),
               full_depth=dict(layers=model.cfg.n_layers,
                               logits_max_abs_err=err, logits_absmax=absmax,
                               half_chunk_sensitivity=sens, tol=bound),
               seconds=time.perf_counter() - t0)
    log(json.dumps({f"{tag}_continuation": rec}))
    if not err_cut <= CONT_TOL:
        raise AssertionError(f"{tag}: at {cut.cfg.n_layers} layers, decode "
                             f"after prefill parts from the prefill of the "
                             f"longer prompt by {err_cut} > {CONT_TOL}")
    if not err <= bound:
        raise AssertionError(f"{tag}: at {model.cfg.n_layers} layers, decode "
                             f"after prefill parts from the prefill of the "
                             f"longer prompt by {err} > {bound}")
    del wide, p32
    return rec


def _widen(tree):
    """A parameter tree with every floating tensor widened to f32."""
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_widen(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


def attention_sensitivity(model, params, toks, max_len: int,
                          tag: str) -> dict:
    """How far the model itself carries a rounding-level change of its
    attention into the first-token logits: the prefill's logits through
    the plain versions (the kernels' tiled walk) against the dense masked
    softmax (another order of the same f32 sums and another p rounding),
    both pure PyTorch.  The kernel path's difference from the plain path
    is held to ``SENSITIVITY_X`` times this where it exceeds
    ``LOGITS_TOL``."""
    plain = model.with_cfg(decode_backend="plain", prefill_backend="plain")
    dense = model.with_cfg(decode_backend="dense", prefill_backend="dense")
    lg_p, _ = plain.prefill(params, toks, max_len=max_len)
    lg_d, _ = dense.prefill(params, toks, max_len=max_len)
    v = model.cfg.vocab
    d = (lg_p - lg_d)[..., :v].abs()
    rec = dict(logits_max_abs=d.max().item(),
               logits_mean_abs=d.mean().item(),
               logits_absmax=lg_p[..., :v].abs().max().item())
    log(json.dumps({f"{tag}_sensitivity": rec}))
    return rec


def zamba2_phase(seed: int = 0) -> dict:
    """zamba2-1.2b at full width under ``tp_bf16``, ``ZAMBA2_LAYERS`` of
    its 38 layers (Mamba2 mixers, d_inner 4096, 64 heads of 64, d_state
    64, chunk 256, and one shared attention + SwiGLU block, 32 heads of
    64, d_ff 8192, read at every sixth position, each with a KV cache of
    its own) through
    ``Model.generate``: ``ZAMBA2_ROWS`` rows of ``ZAMBA2_PROMPT`` tokens,
    ``GEN_LEN`` greedy tokens (``generate_arch``: decode ``mma`` at group 1
    over contiguous strips, flash ``flash_tc`` at (64, 64), causal;
    first-token logits against the plain versions, streams to a near
    tie, within ``max(LOGITS_TOL, SENSITIVITY_X x`` the model's own
    sensitivity: ``attention_sensitivity``).  Gates of its own: the
    launches are the shared layers times the calls (two prefills,
    ``GEN_LEN - 1`` decode steps), none non-causal; the continuation gate
    under ``fp32``."""
    model, params = arch_model("zamba2-1.2b", ZAMBA2_LAYERS, ZAMBA2_NEED_GIB,
                               "zamba2", seed)
    cfg = model.cfg
    shared = sum(s.mixer == "shared_attn" for s in cfg.layer_list())
    toks = _uniform(ZAMBA2_ROWS, ZAMBA2_PROMPT, cfg.vocab, seed + 14)
    max_len = ZAMBA2_PROMPT + GEN_LEN
    rule = strip_rule(cfg, ZAMBA2_ROWS, (max_len,))
    sens = attention_sensitivity(model, params, toks, max_len, "zamba2")
    rec, counted, _ = generate_arch(
        model, params, toks, None, "zamba2", None, rule, 1, "64x64",
        classes=RECURRENT_CLASSES, window=RECURRENT_WINDOW,
        logits_tol=max(LOGITS_TOL, SENSITIVITY_X * sens["logits_max_abs"]))
    want = {"flash_attention": shared * 2,
            "decode_attention": shared * (GEN_LEN - 1)}
    if counted["launches"] != want or counted["flash_launches_noncausal"]:
        raise AssertionError(f"zamba2: attention launches "
                             f"{counted['launches']} (non-causal "
                             f"{counted['flash_launches_noncausal']}), "
                             f"expected {want}, all causal")
    rec.update(arch=cfg.name, layers=cfg.n_layers,
               attention_layers=shared, sensitivity=sens,
               continuation=continuation_gate(model, params, toks, "zamba2",
                                              seed + 15),
               **state_bytes(model, max_len), card=card_line(), **counted)
    log(json.dumps({"zamba2": rec}))
    return rec


def xlstm_phase(seed: int = 0) -> dict:
    """xlstm-1.3b at full width under ``tp_bf16``, ``XLSTM_LAYERS`` of its
    48 layers (7 mLSTM mixers, 4 heads of 1024 with an f32 [1024, 1024]
    memory each, chunk 256, to 1 sLSTM mixer, 4 heads of 512, a sequential
    loop over time, with a gated gelu FFN tail) through ``Model.generate``:
    ``XLSTM_ROWS`` rows of ``XLSTM_PROMPT`` tokens, ``GEN_LEN`` greedy
    tokens (``generate_arch`` without attention: no attention kernel may
    launch).  The continuation gate under ``fp32``."""
    model, params = arch_model("xlstm-1.3b", XLSTM_LAYERS, XLSTM_NEED_GIB,
                               "xlstm", seed)
    cfg = model.cfg
    toks = _uniform(XLSTM_ROWS, XLSTM_PROMPT, cfg.vocab, seed + 16)
    max_len = XLSTM_PROMPT + GEN_LEN
    rec, counted, _ = generate_arch(model, params, toks, None, "xlstm", None,
                                    None, 0, "", classes=RECURRENT_CLASSES,
                                    window=RECURRENT_WINDOW)
    rec.update(arch=cfg.name, layers=cfg.n_layers,
               continuation=continuation_gate(model, params, toks, "xlstm",
                                              seed + 17),
               **state_bytes(model, max_len), card=card_line(), **counted)
    log(json.dumps({"xlstm": rec}))
    return rec


# ---------------------------------------------------------------------------
# phase 17: transprecision training
# ---------------------------------------------------------------------------
#: the JAX training launcher's defaults (``launch/train.py``): seq 256,
#: global batch 16, lr 3e-3, AdamW; warm-up 10 steps
TRAIN_SEQ, TRAIN_BATCH, TRAIN_LR, TRAIN_WARMUP = 256, 16, 3e-3, 10
#: run (a): ``tp_bf16`` for this many steps, a checkpoint every
#: ``TRAIN_CKPT_EVERY``; run (d) is its first ``TRAIN_RESTART_STEPS`` with
#: a failure injected at ``TRAIN_FAIL_AT``
TRAIN_STEPS, TRAIN_CKPT_EVERY = 100, 40
TRAIN_RESTART_STEPS, TRAIN_FAIL_AT = 60, 50
#: runs (b) and (c): policy and steps (each its own schedule), cut to keep
#: the phase near 100 s; fp32 at 40 steps fell by 0.16 only on an H100
#: (the loss climbs for some 15 steps after warm-up).  They run without
#: remat, which gives the same gradients bit for bit
#: (``tests/test_torch_train.py::test_remat_policies_give_bitwise_equal_grads``)
#: and skips a forward's worth of host and emulation work a step
TRAIN_OTHERS = (("fp32", 80), ("em_fp8", 60))
#: each run's last-5 mean loss must sit this far below its first-5 mean
#: (the JAX suite's bar, ``tests/test_train.py``)
TRAIN_DROP = 0.5
#: steps of the profiled window
TRAIN_PROFILE_STEPS = 5


def train_loop(policy: str, steps: int, total: int, ckpt_dir=None,
               plan=None, remat: bool = True):
    """A ``TrainLoop`` over full-width fpnew-case-study (seed-0 port
    weights) on the card, its optimizer scheduled over ``total`` steps and
    the loop stopping at ``steps``."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.registry import build_model
    from repro_torch.optim.optimizer import OptConfig
    from repro_torch.train.loop import LoopConfig, TrainLoop
    model = build_model("fpnew-case-study", policy=policy, device="cuda",
                        prefill_backend="dense")
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                    total_steps=total)
    data = DataConfig(vocab=model.cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    lc = LoopConfig(total_steps=steps, log_every=0,
                    ckpt_every=TRAIN_CKPT_EVERY if ckpt_dir else 0,
                    ckpt_dir=ckpt_dir, keep_ckpts=2, remat=remat)
    return TrainLoop(model, opt, data, lc, failure_plan=plan)


def loss_summary(where: str, log_: list) -> dict:
    """Gates a run's losses and gradient norms (finite, the last-5 mean
    ``TRAIN_DROP`` below the first-5) and summarises them."""
    import statistics
    loss = [r["loss"] for r in log_]
    gnorm = [r["grad_norm"] for r in log_]
    if not all(math.isfinite(x) for x in loss + gnorm):
        raise AssertionError(f"{where}: a loss or gradient norm is not "
                             f"finite")
    first5, last5 = statistics.mean(loss[:5]), statistics.mean(loss[-5:])
    if not last5 < first5 - TRAIN_DROP:
        raise AssertionError(f"{where}: last-5 mean loss {last5} is not "
                             f"{TRAIN_DROP} below the first-5 {first5}")
    dts = sorted(r["dt"] for r in log_[5:])
    ms = statistics.median(dts) * 1e3
    return dict(steps=len(loss), first5=first5, last5=last5,
                first10=statistics.mean(loss[:10]),
                last10=statistics.mean(loss[-10:]),
                final_loss=loss[-1], max_grad_norm=max(gnorm),
                ms_per_step=ms, tokens_s=TRAIN_SEQ * TRAIN_BATCH / ms * 1e3)


def _kernel_launches() -> dict:
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.dotp_ex import dotp_ex_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.tp_matmul import tp_matmul_cuda
    from repro_torch.kernels.tp_quant import (cast_and_pack_cuda,
                                              tp_quantize_cuda)
    return {fn.__name__: fn.launches for fn in (
        decode_attention_cuda, flash_attention_cuda, tp_matmul_cuda,
        tp_quantize_cuda, cast_and_pack_cuda, dotp_ex_cuda)}


#: device-time classes of the training step: the projections' and the
#: CE's unbatched GEMMs (``aten::mm``: forward, recompute, backward), the
#: dense attention's batched einsums (``aten::bmm``), and everything the
#: optimizer launches (under ``train.optimizer``)
TRAIN_GEMM_OPS = ("aten::mm", "aten::addmm")


def train_profile(run, wall: float) -> dict:
    """Device busy and idle of ``run()`` under ``torch.profiler`` (CPU and
    CUDA activity, so each kernel is tied to the op that launched it)
    against ``wall``, and the busy time split gemm / attention / optimizer
    / other by the launching op."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # device activity less the ``record_function`` ranges' GPU spans
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e6)
    busy = sum(by_name.values())
    by_class = dict(gemm=0.0, attention=0.0, optimizer=0.0, other=0.0)
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU or not ev.kernels:
            continue
        sec = sum(k.duration for k in ev.kernels) / 1e6
        anc, cls = ev, None
        while anc is not None and cls is None:
            if anc.name == "train.optimizer":
                cls = "optimizer"
            anc = anc.cpu_parent
        if cls is None:
            cls = ("gemm" if ev.name in TRAIN_GEMM_OPS else
                   "attention" if ev.name == "aten::bmm" else "other")
        by_class[cls] += sec
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(steps=TRAIN_PROFILE_STEPS, wall_s=wall, device_busy_s=busy,
                device_idle_share=(1.0 - busy / wall) if busy else None,
                device_s_by_class=by_class,
                classified_s=sum(by_class.values()),
                top_kernels=[[k[:90], sec] for k, sec in top])


def train_phase(seed: int = 0) -> dict:
    """Full-width fpnew-case-study (12 layers, d_model 768, 12 heads of 64,
    d_ff 2048, vocab 32000, tied: 109.6M parameters) trained through
    ``TrainLoop`` from seed-0 port weights on the JAX launcher's defaults
    (seq 256, batch 16, lr 3e-3, warm-up 10, AdamW, remat ``full``):

    (a) ``tp_bf16``, ``TRAIN_STEPS`` steps, checkpoints every 40 into a
        temporary directory (and at step 60, where the state is kept);
    (b) / (c) ``fp32`` and ``em_fp8`` (``TRAIN_OTHERS`` steps, no remat);
    (d) (a)'s first 60 steps with a failure injected at step 50 under
        ``run_with_restarts``.

    (a) and (d) run under ``torch.use_deterministic_algorithms(True)``.
    Gates: every loss and gradient norm finite, each run's last-5 mean
    loss ``TRAIN_DROP`` below its first-5, (d) resumes at step 40 and
    its state at step 60 equals (a)'s bit for bit, and no hand-written
    kernel launches (training attention is the dense path).  Logged: ms
    a step (median after 5) and tokens/s, a profiled 5-step window
    (busy / idle, gemm / attention / optimizer / other), checkpoint save
    and restore seconds and GB, each policy's first-10 / last-10 means."""
    import shutil
    import tempfile
    import torch
    from repro_torch.core.tree import leaves
    from repro_torch.train.fault import FailurePlan, run_with_restarts

    free_memory_gate("train", 8.0)
    torch.cuda.reset_peak_memory_stats()
    launches0 = _kernel_launches()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    # bitwise repeats need the deterministic kernels, not NaN-filled
    # fresh allocations (a fill kernel for every empty tensor)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    res = dict(arch="fpnew-case-study", seq=TRAIN_SEQ, batch=TRAIN_BATCH,
               lr=TRAIN_LR, warmup=TRAIN_WARMUP)
    try:
        # (a), in two legs so the state at step 60 can be kept
        a = train_loop("tp_bf16", TRAIN_RESTART_STEPS, TRAIN_STEPS,
                       os.path.join(tmp, "a"))
        n_params = sum(t.numel() for t in leaves(a.params))
        log(f"train: fpnew-case-study full width, {n_params / 1e6:.2f}M "
            f"parameters, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            f"with the optimizer state")
        t0 = time.perf_counter()
        a.run()
        at60 = [t.clone() for t in leaves(a.state_tree())]
        a.loop_cfg.total_steps = TRAIN_STEPS
        a.run()
        torch.cuda.synchronize()
        res["a_tp_bf16"] = dict(loss_summary("train (a)", a.metrics_log),
                                wall_s=time.perf_counter() - t0,
                                deterministic=True)
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(json.dumps({"train_a": res["a_tp_bf16"]}))

        # a profiled window of 5 more steps (off the loop's state)
        batches = [{k: v.to("cuda") for k, v in
                    a.data.batch_at(TRAIN_STEPS + i).items()}
                   for i in range(TRAIN_PROFILE_STEPS)]

        def window():
            p, s = a.params, a.opt_state
            for b in batches:
                p, s, _ = a.step_fn(p, s, b)

        window()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        res["where_the_time_goes"] = train_profile(
            window, time.perf_counter() - t0)
        log(json.dumps({"train_where_the_time_goes":
                        res["where_the_time_goes"]}))

        # checkpoint save and restore, timed
        nbytes = sum(t.numel() * t.element_size()
                     for t in leaves(a.state_tree()))
        t0 = time.perf_counter()
        a.ckpt.save(a.step, a.state_tree(),
                    extra={"data": a.data.state_dict()}, sync=True)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        step, tree, _ = a.ckpt.restore_latest(a.state_tree())
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if step != TRAIN_STEPS or not all(
                torch.equal(x, y) for x, y in zip(leaves(tree),
                                                  leaves(a.state_tree()))):
            raise AssertionError("train: the checkpoint did not restore "
                                 "the state bit for bit")
        res["checkpoint"] = dict(gb=nbytes / 1e9, save_s=save_s,
                                 restore_s=restore_s,
                                 save_gb_s=nbytes / 1e9 / save_s,
                                 restore_gb_s=nbytes / 1e9 / restore_s)
        log(json.dumps({"train_checkpoint": res["checkpoint"]}))
        del tree, a
        gc_cuda()

        # (d): (a)'s first 60 steps, a failure at 50, restarted
        plan = FailurePlan(fail_at=(TRAIN_FAIL_AT,))
        t0 = time.perf_counter()
        d, restarts = run_with_restarts(
            lambda: train_loop("tp_bf16", TRAIN_RESTART_STEPS, TRAIN_STEPS,
                               os.path.join(tmp, "d"), plan),
            max_restarts=1)
        torch.cuda.synchronize()
        resumed = d.metrics_log[0]["step"]
        if not all(math.isfinite(r["loss"]) and math.isfinite(
                r["grad_norm"]) for r in d.metrics_log):
            raise AssertionError("train (d): a loss or gradient norm is not "
                                 "finite")
        same = [torch.equal(x, y) for x, y in
                zip(leaves(d.state_tree()), at60)]
        res["d_restart"] = dict(restarts=restarts, resumed_at=resumed,
                                wall_s=time.perf_counter() - t0,
                                leaves_bitwise_equal=sum(same),
                                of=len(same))
        log(json.dumps({"train_d": res["d_restart"]}))
        if restarts != 1 or resumed != TRAIN_CKPT_EVERY:
            raise AssertionError(f"train (d): {restarts} restarts, resumed "
                                 f"at step {resumed}, not "
                                 f"{TRAIN_CKPT_EVERY}")
        if not all(same):
            raise AssertionError("train (d): the restarted run's state at "
                                 "step 60 differs from (a)'s")
        del d, at60
        gc_cuda()
        torch.use_deterministic_algorithms(False)

        # (b), (c)
        for policy, steps in TRAIN_OTHERS:
            t0 = time.perf_counter()
            run = train_loop(policy, steps, steps, remat=False)
            run.run()
            torch.cuda.synchronize()
            res[policy] = dict(loss_summary(f"train ({policy})",
                                            run.metrics_log),
                               wall_s=time.perf_counter() - t0,
                               deterministic=False)
            log(json.dumps({f"train_{policy}": res[policy]}))
            del run
            gc_cuda()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        shutil.rmtree(tmp, ignore_errors=True)
    launched = {k: v - launches0[k] for k, v in _kernel_launches().items()}
    if any(launched.values()):
        raise AssertionError(f"train: hand-written kernels launched on the "
                             f"training path: {launched}")
    res.update(kernel_launches=launched, card=card_line())
    log(json.dumps({"train": {k: v for k, v in res.items()
                              if k != "where_the_time_goes"}}))
    return res


# ---------------------------------------------------------------------------
# training under a mesh: two gloo ranks on the one card
# ---------------------------------------------------------------------------
#: steps of each case: (e) dp plain, (f) each compressed format, (g) tp,
#: (h) ZeRO-1 (its params held to (e)'s at this step), (i) the continued
#: restores; (e) checkpoints at ``TRAIN_MESH_CKPT_AT``
TRAIN_MESH_STEPS = dict(e=10, f=10, g=5, h=3, i=3)
TRAIN_MESH_CKPT_AT = 5
TRAIN_MESH_COMPRESS = ("fp8", "fp16alt")
#: the first step against the unsharded step on the whole batch (tp_bf16:
#: ``tests/test_torch_train.py``'s bounds): the loss and the gradient
#: norm; and the step's update (the master after it less the master
#: before it) by relative L2 over the leaves whose reference gradient is
#: not zero, whole and per leaf.  An update that never happened reads
#: 1.0 on both; a sound sync reads the share of Adam's first sign(g) lr
#: steps that flip where a bf16 gradient sits within rounding of 0
TRAIN_MESH_LOSS_TOL, TRAIN_MESH_GRAD_REL = 5e-3, 3e-2
TRAIN_MESH_UPDATE_REL, TRAIN_MESH_UPDATE_LEAF_REL = 0.2, 0.5
#: a sharded run's losses against the unsharded run's, step by step (bf16
#: sums in another order drift apart over the steps: 1.32e-3 at most on
#: an H100, where a run without updates reads about 0.1)
TRAIN_MESH_TRACK = 1e-2
#: the compressed runs against (e): their losses, step by step, within
#: ``TRAIN_MESH_BAND`` (the largest sound gap read 4.4e-3, fp8) and within
#: 1 / ``TRAIN_MESH_CONTROL_X`` of the gap that a run without updates
#: (the seed-0 weights' losses on the same batches) shows to (e); the
#: first step's gradient norm within ``TRAIN_MESH_NORM_REL`` of (e)'s
#: (Adam's step is blind to the gradient's scale: a sync that drops the
#: gradient reads 1.0 there, one that halves it 0.5)
TRAIN_MESH_BAND, TRAIN_MESH_CONTROL_X, TRAIN_MESH_NORM_REL = 2e-2, 4.0, 5e-2
TRAIN_MESH_NEED_GIB = 16.0


def train_mesh_phase(seed: int = 0) -> dict:
    """Training under a ``(data, model)`` mesh on the one card: two gloo
    ranks (NCCL refuses two ranks on one GPU), full-width
    fpnew-case-study under ``tp_bf16`` on ``train_phase``'s settings (seq
    256, global batch 16, lr 3e-3, warm-up 10, AdamW, remat ``full``,
    seed-0 weights), deterministic algorithms on.  Cases
    (``train.mesh_checks.card_rank``, every number per rank):

    (e) dp (2, 1), plain f32 sync, ``TrainLoop(mesh=)`` 10 steps: the
        first step's loss, gradient norm and update against the
        unsharded step on the whole batch, the losses against the
        unsharded run's (run here first);
    (f) dp (2, 1) with ``compress_grads`` fp8 and fp16alt, 10 steps each:
        finite, within ``TRAIN_MESH_BAND`` of (e) and well inside the gap
        of a run without updates, the first gradient norm as (e)'s, error
        feedback nonzero after step 1, wire bytes a step a rank;
    (g) tp (1, 2): the first step's loss and every leaf's gradient,
        gathered whole, against the unsharded step's; 5 steps, their
        collectives and staged bytes;
    (h) ZeRO-1 through the ``jit_train_step`` twin at (2, 1), 3 steps:
        params bitwise (e)'s at step 3; state bytes a rank and whole;
    (i) (e)'s step-5 checkpoint restored under (1, 2) (on the ranks) and
        under no mesh (here): the restored state bitwise the saved one,
        3 more steps tracking the unsharded run.

    No hand-written kernel launches on any rank."""
    import shutil
    import statistics
    import tempfile
    import torch
    from repro_torch.ckpt.checkpoint import restore_pytree
    from repro_torch.core.tree import leaves
    from repro_torch.launch import spmd
    from repro_torch.train import mesh_checks as mc

    t_phase = time.perf_counter()
    free_memory_gate("train mesh", TRAIN_MESH_NEED_GIB)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    launches0 = _kernel_launches()
    st = TRAIN_MESH_STEPS
    seq, batch = TRAIN_SEQ, TRAIN_BATCH
    opt = dict(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=st["e"])
    root = tempfile.mkdtemp(prefix="chip_smoke_train_mesh_")
    res = dict(arch="fpnew-case-study", policy="tp_bf16", seq=seq,
               batch=batch, ranks=TP_RANKS, backend="gloo, one card (not "
               "NCCL)")
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.use_deterministic_algorithms(True)
    try:
        model = mc._model("fpnew-case-study", "tp_bf16", "cuda",
                          reduced=False)
        oracle = mc._loop(model, None, steps=st["e"], batch=batch, seq=seq,
                          opt=opt, seed=seed)
        n_params = sum(t.numel() for t in leaves(oracle.params))
        # the control: the seed-0 weights' losses on the run's batches
        with torch.no_grad():
            control = [float(model.forward_train(
                oracle.params, *(oracle.data.batch_at(k)[n].to("cuda")
                                 for n in ("tokens", "labels")),
                remat=False)) for k in range(st["e"])]
        t0 = time.perf_counter()
        oracle.run()
        torch.cuda.synchronize()
        u_loss = [r["loss"] for r in oracle.metrics_log]
        u_dt = [r["dt"] for r in oracle.metrics_log]
        res["unsharded"] = dict(losses=u_loss, wall_s=time.perf_counter() - t0,
                                ms_per_step=statistics.median(u_dt[1:]) * 1e3,
                                n_params=n_params, no_update_losses=control)
        del oracle
        gc_cuda()
        spec = dict(policy="tp_bf16", seq=seq, batch=batch, opt=opt,
                    seed=seed, steps=st, ckpt_at=TRAIN_MESH_CKPT_AT,
                    root=root, compress=TRAIN_MESH_COMPRESS)
        t0 = time.perf_counter()
        ranks = spmd.spawn(mc.card_rank, TP_RANKS, backend="gloo",
                           args=(spec,), timeout=900)
        res["spawn_s"] = time.perf_counter() - t0
        r0 = ranks[0]
        # every rank computed the same losses (replicated after the sync)
        for tag in ["e", "g", "i"] + ["f_" + f for f in TRAIN_MESH_COMPRESS]:
            if any(r[tag]["losses"] != r0[tag]["losses"] for r in ranks):
                raise AssertionError(f"train mesh ({tag}): the ranks' "
                                     f"losses differ")
        gaps = lambda got, want: [abs(a - b) for a, b in zip(got, want)]
        ms = lambda dts: statistics.median(dts[1:] or dts) * 1e3
        e = r0["e"]
        e_gap = gaps(e["losses"], u_loss)
        control_gap = max(gaps(control, e["losses"]))
        res["e_dp"] = dict(
            first_loss_gap=e["first_loss_vs_unsharded"],
            grad_norm_rel=abs(e["first_grad_norm"] - e["unsharded_grad_norm"])
            / e["unsharded_grad_norm"],
            update_rel_after_1=max(r["e"]["update_rel_after_1"]
                                   for r in ranks),
            update_leaf_rel_max=max(r["e"]["update_leaf_rel_max"]
                                    for r in ranks),
            update_leaves=[e["update_leaves"], e["leaves"]],
            loss_gap_max=max(e_gap), no_update_gap_max=control_gap,
            losses=e["losses"], ms_per_step=ms(e["dts"]), wall_s=e["wall_s"],
            collectives_per_step=e["spmd"]["collectives"] / e["spmd_steps"],
            staged_bytes_per_step=e["spmd"]["staged_bytes"]
            / e["spmd_steps"],
            wire_bytes_per_step={k: v / e["spmd_steps"] for k, v in
                                 e["spmd"]["wire_bytes"].items()})
        d = res["e_dp"]
        log(json.dumps({"train_mesh_e": d}))
        if not (d["first_loss_gap"] <= TRAIN_MESH_LOSS_TOL
                and d["grad_norm_rel"] <= TRAIN_MESH_GRAD_REL
                and d["update_rel_after_1"] <= TRAIN_MESH_UPDATE_REL
                and d["update_leaf_rel_max"] <= TRAIN_MESH_UPDATE_LEAF_REL
                and d["loss_gap_max"] <= TRAIN_MESH_TRACK):
            raise AssertionError(f"train mesh (e): {d}")
        for fmt in TRAIN_MESH_COMPRESS:
            f = r0["f_" + fmt]
            band = max(gaps(f["losses"], e["losses"]))
            res["f_" + fmt] = dict(
                losses=f["losses"], band_max=band,
                no_update_gap_max=control_gap,
                grad_norm_rel=abs(f["first_grad_norm"]
                                  - e["first_grad_norm"])
                / e["first_grad_norm"],
                ef_max_after_1=f["ef_max_after_1"],
                wire_bytes_per_step=f["wire_bytes_per_step"],
                ms_per_step=ms(f["dts"]), wall_s=f["wall_s"])
            d = res["f_" + fmt]
            log(json.dumps({"train_mesh_f_" + fmt: d}))
            want = {fmt: 2 * n_params}
            if not (all(math.isfinite(x) for x in f["losses"])
                    and band <= TRAIN_MESH_BAND
                    and band <= control_gap / TRAIN_MESH_CONTROL_X
                    and d["grad_norm_rel"] <= TRAIN_MESH_NORM_REL
                    and f["ef_max_after_1"] > 0
                    and f["wire_bytes_per_step"] == want):
                raise AssertionError(f"train mesh (f {fmt}): {d} (wire "
                                     f"{want})")
        g = r0["g"]
        res["g_tp"] = dict(
            first_loss_gap=g["first_loss_vs_unsharded"],
            grad_rel_max=max(max(r["g"]["grad_rel"]) for r in ranks),
            loss_gap_max=max(gaps(g["losses"], u_loss)), losses=g["losses"],
            local=(g["local_heads"], g["local_mlp_cols"],
                   g["local_vocab_rows"]),
            ms_per_step=ms(g["dts"]), wall_s=g["wall_s"],
            collectives_per_step=g["spmd"]["collectives"] / st["g"],
            staged_bytes_per_step=g["spmd"]["staged_bytes"] / st["g"],
            grad_step_collectives=g["grad_step_spmd"]["collectives"])
        d = res["g_tp"]
        if not (d["first_loss_gap"] <= TRAIN_MESH_LOSS_TOL
                and d["grad_rel_max"] <= TRAIN_MESH_GRAD_REL
                and d["loss_gap_max"] <= TRAIN_MESH_TRACK
                and tuple(d["local"]) == (6, 1024, 16000)):
            raise AssertionError(f"train mesh (g): {d}")
        h = r0["h"]
        res["h_zero1"] = dict(
            bitwise=[r["h"]["bitwise"] for r in ranks], of=h["of"],
            ms_per_step=ms(h["dts"]), wall_s=h["wall_s"],
            state_bytes_rank=h["state_bytes_rank"],
            state_bytes_whole=h["state_bytes_whole"])
        if any(r["h"]["bitwise"] != h["of"] for r in ranks):
            raise AssertionError(f"train mesh (h): params not bitwise (e)'s "
                                 f"at step {st['h']}: {res['h_zero1']}")
        i = r0["i"]
        # (i) here: the same checkpoint restored under no mesh
        lp = mc._loop(model, None, steps=TRAIN_MESH_CKPT_AT + st["i"],
                      batch=batch, seq=seq, opt=opt, seed=seed,
                      ckpt_every=0, ckpt_dir=os.path.join(root, "e"))
        saved, _ = restore_pytree(lp.ckpt.path(TRAIN_MESH_CKPT_AT),
                                  lp.state_tree())
        same = sum(torch.equal(a, b) for a, b in
                   zip(leaves(saved), leaves(lp.state_tree())))
        n_leaves = len(leaves(saved))
        at, lp.ckpt = lp.step, None         # restored: no more writes
        del saved
        lp.run()
        want = u_loss[TRAIN_MESH_CKPT_AT:TRAIN_MESH_CKPT_AT + st["i"]]
        res["i_elastic"] = dict(
            tp_restored_at=i["restored_at"],
            tp_bitwise=[r["i"]["bitwise"] for r in ranks], of=i["of"],
            tp_loss_gap_max=max(gaps(i["losses"], want)),
            none_restored_at=at, none_bitwise=same, none_of=n_leaves,
            none_loss_gap_max=max(gaps([r["loss"] for r in lp.metrics_log],
                                       want)))
        d = res["i_elastic"]
        if not (d["tp_restored_at"] == d["none_restored_at"]
                == TRAIN_MESH_CKPT_AT
                and all(b == d["of"] for b in d["tp_bitwise"])
                and d["none_bitwise"] == d["none_of"]
                and d["tp_loss_gap_max"] <= TRAIN_MESH_TRACK
                and d["none_loss_gap_max"] <= TRAIN_MESH_TRACK):
            raise AssertionError(f"train mesh (i): {d}")
        del lp
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        shutil.rmtree(root, ignore_errors=True)
    launched = {k: v - launches0[k] for k, v in _kernel_launches().items()}
    for r in ranks:
        for k, v in r["kernel_launches"].items():
            launched[k] = launched.get(k, 0) + v
    if any(launched.values()):
        raise AssertionError(f"train mesh: hand-written kernels launched "
                             f"on the training path: {launched}")
    res.update(kernel_launches=launched, phase_s=time.perf_counter() - t_phase,
               card=card_line())
    log(json.dumps({"train_mesh": res}))
    return res


#: the other archs under a training mesh, each at full width cut in depth
#: to fit two gloo ranks and rank 0's unsharded reference (its AdamW
#: state at ~20 B a parameter) on the one card: (tag, arch, config
#: overrides, meshes, options: ``lively`` norms, the recurrent stacks'
#: ``sensitivity`` (their gradient and update at half the mixers' chunk,
#: another order of the same sums), whose ``SENSITIVITY_X`` multiple
#: widens their gradient and update gates where it exceeds them, and a
#: ``policy`` of the leg's own: xlstm's bf16 gradient is noise at this
#: depth, its own move at half the chunk 1.7 on a leaf and 0.87 on the
#: whole update, so its leg runs and is gated under ``fp32``)
TRAIN_MESH_ARCH_LEGS = (
    ("j", "qwen3-moe-30b-a3b", dict(n_layers=1), ((1, 2),), {}),
    ("k", "deepseek-v2-lite-16b", dict(n_layers=2), ((2, 1), (1, 2)), {}),
    ("l", "minicpm3-4b", dict(n_layers=4), ((1, 2),), {}),
    ("m", "zamba2-1.2b", dict(n_layers=6, suffix=()), ((1, 2),),
     dict(sensitivity=True)),
    ("n", "xlstm-1.3b", dict(n_layers=8), ((1, 2),), dict(policy="fp32")),
    ("o", "whisper-small", {}, ((1, 2),), dict(lively=True)))
#: the legs small enough (rank 0's reference at most 26 GB) run beside
#: the fpnew mesh phase and the unsharded train phase from the start; the
#: MoE legs (41.8–48.8 GB), these, wait for the fpnew mesh phase to end
TRAIN_MESH_ARCH_LATE = ("j", "k")
#: the global batch of each leg's one step (gated against the unsharded
#: step and timed: a second, timed step cost the smoke ~16 s)
TRAIN_MESH_ARCH_BATCH = 4
#: the MoE aux statistic against the unsharded step's, by mesh
#: (``train.train_step``'s table)
TRAIN_MESH_AUX_TOL = 1e-5
#: free memory each group of legs needs at its start: rank 0's unsharded
#: reference of its largest leg (qwen3-moe, 1.24B parameters: bf16
#: weights and gradients, AdamW's f32 state twice over during the update,
#: 48.8 GiB at its peak; whisper's 25.9 among the early legs)
TRAIN_MESH_ARCHS_NEED_GIB = {"early": 28.0, "late": 50.0}
#: the file whose existence starts the late legs
TRAIN_MESH_ARCHS_GO = "late_legs_go"


def train_mesh_archs_gates(legs, ranks) -> tuple:
    """``(per-leg results, failed gates)`` of ``train_mesh_archs_phase``'s
    ranks (``card_arch_rank``'s returns), each leg's result logged."""
    out_legs, bad = {}, []
    for leg in legs:
        tag, r0 = leg["tag"], ranks[0][leg["tag"]]
        u = r0["unsharded"]
        out = dict(arch=leg["arch"], layers=r0["layers"],
                   policy=r0["policy"],
                   n_params=r0["n_params"], unsharded_loss=u["loss"],
                   unsharded_aux=u["aux"], unsharded_ms_per_step=u["ms"],
                   routes_pinned=r0["routes_recorded"],
                   unsharded_s=u["seconds"], unsharded_parts_s=u["parts_s"],
                   ready_s=[r[tag]["ready_s"] for r in ranks],
                   wall_s=[r[tag]["wall_s"] for r in ranks],
                   peak_gib=[r[tag]["peak_gib"] for r in ranks])
        n_leaves = len(r0[f"{leg['dims'][0][0]}x{leg['dims'][0][1]}"][
            "grad_rel"])
        # each leaf's bounds: the gates', or SENSITIVITY_X times a
        # recurrent stack's own move at half its chunk where that is larger
        g_bound = [max(TRAIN_MESH_GRAD_REL, SENSITIVITY_X * x)
                   for x in u.get("grad_sens", [0.0] * n_leaves)]
        u_bound = [max(TRAIN_MESH_UPDATE_LEAF_REL, SENSITIVITY_X * x)
                   for x in u.get("update_sens", [0.0] * n_leaves)]
        uw_bound = max(TRAIN_MESH_UPDATE_REL,
                       SENSITIVITY_X * u.get("update_sens_whole", 0.0))
        if "grad_sens" in u:
            out.update(grad_sens_max=max(u["grad_sens"]),
                       update_sens_max=max(u["update_sens"]),
                       update_sens_whole=u["update_sens_whole"],
                       update_rel_bound=uw_bound)
        for dims in leg["dims"]:
            key = f"{dims[0]}x{dims[1]}"
            g = r0[key]
            per = [r[tag][key] for r in ranks]
            live = [(x, b) for x, b in zip(g["update_leaf_rel"], u_bound)
                    if x is not None]
            d = dict(
                loss_gap=abs(g["loss"] - u["loss"]),
                grad_rel_max=max(g["grad_rel"]),
                grad_rel_of_bound_max=max(
                    x / b for x, b in zip(g["grad_rel"], g_bound)),
                update_rel=g["update_rel"],
                update_leaf_rel_max=max(x for x, _ in live),
                update_leaf_rel_of_bound_max=max(x / b for x, b in live),
                aux=g["aux"], aux_gap=abs(g["aux"] - u["aux"]),
                loss=g["loss"],
                ms_per_step=[p["ms"] for p in per],
                setup_s=[p["setup_s"] for p in per],
                compare_s=[p["compare_s"] for p in per],
                collectives_per_step=[p["spmd"]["collectives"] for p in per],
                staged_bytes_per_step=[p["spmd"]["staged_bytes"]
                                       for p in per],
                wire_bytes_per_step=[p["spmd"]["wire_bytes"] for p in per],
                state_bytes_rank=[p["state_bytes"] for p in per],
                param_bytes_rank=[p["param_bytes"] for p in per])
            out[key] = d
            ok = (d["loss_gap"] <= TRAIN_MESH_LOSS_TOL
                  and d["grad_rel_of_bound_max"] <= 1.0
                  and d["update_rel"] <= uw_bound
                  and d["update_leaf_rel_of_bound_max"] <= 1.0
                  and math.isfinite(d["loss"])
                  and all(p["loss"] == g["loss"] for p in per))
            if r0["routes_recorded"]:
                ok = ok and d["aux_gap"] <= TRAIN_MESH_AUX_TOL
            if not ok:
                bad.append(f"({tag}) {leg['arch']} {key}: {d}")
        out_legs[tag] = out
        log(json.dumps({f"train_mesh_{tag}": out}))
    return out_legs, bad


def train_mesh_archs_phase(go_dir: str, seed: int = 0) -> dict:
    """Training under a mesh for the archs beyond the dense ones, two gloo
    ranks on the one card (``train.mesh_checks.card_arch_rank``, one
    spawn for every leg), ``tp_bf16``, seq 256, global batch 4, AdamW as
    ``train_mesh_phase``, seed-0 weights (whisper's layernorms lively):

    (j) qwen3-moe-30b-a3b, 1 layer, at (1, 2): expert parallel, 64 of its
        128 experts a rank, qk-norm heads sharded;
    (k) deepseek-v2-lite-16b, its dense layer 0 and one MoE layer, at
        (2, 1) (the aux over the global batch) and at (1, 2) (MLA's 16
        heads sharded, expert parallel, shared experts tensor parallel);
    (l) minicpm3-4b, 4 of 62 layers, at (1, 2) (q-LoRA MLA, 40 heads);
    (m) zamba2-1.2b, 5 Mamba2 layers and the shared attention block, at
        (1, 2);
    (n) xlstm-1.3b, one pattern (7 mLSTM, 1 sLSTM), at (1, 2), under
        ``fp32`` (under ``tp_bf16`` its gradient moves by O(1) between
        two chunk sizes of the unsharded step: noise to gate on);
    (o) whisper-small, 12 + 12 layers, seeded frame embeddings [4, 1500,
        768], at (1, 2) (the encoder sharded too).

    (l)–(o) run first; (j) and (k) start once ``go_dir`` holds
    ``TRAIN_MESH_ARCHS_GO`` (``main`` writes it when the fpnew mesh phase
    has ended) and the card has ``TRAIN_MESH_ARCHS_NEED_GIB["late"]``
    free.  One step a leg and mesh, gated (rank 0 against its unsharded
    step on the whole batch, the MoE routes of that step pinned in the
    sharded one: ``RouteTape``): the loss within ``TRAIN_MESH_LOSS_TOL``,
    every leaf's gradient over the whole leaf (its blocks' sums, each
    rank sent its block of the reference) within
    ``TRAIN_MESH_GRAD_REL``, the update within ``TRAIN_MESH_UPDATE_REL``
    whole and ``TRAIN_MESH_UPDATE_LEAF_REL`` a leaf (for the recurrent
    stacks, (m) and (n), each bound or ``SENSITIVITY_X`` times the
    stack's own move when its mixers run at half their chunk, whichever
    is larger, as the serving phases gate them), the MoE aux within
    ``TRAIN_MESH_AUX_TOL``; the loss finite and the same on both ranks;
    no hand-written kernel launches on any rank.  The gated step is the
    timed one, collectives included (the first of its shapes on the
    ranks: its ms includes first-call costs)."""
    from repro_torch.launch import spmd
    from repro_torch.train import mesh_checks as mc

    t_phase = time.perf_counter()
    free_memory_gate("train mesh archs", TRAIN_MESH_ARCHS_NEED_GIB["early"])
    launches0 = _kernel_launches()
    order = sorted(TRAIN_MESH_ARCH_LEGS,
                   key=lambda leg: leg[0] in TRAIN_MESH_ARCH_LATE)
    legs = [dict(tag=t, arch=a, cfg=c, dims=list(d), **o)
            for t, a, c, d, o in order]
    spec = dict(policy="tp_bf16", seq=TRAIN_SEQ,
                batch=TRAIN_MESH_ARCH_BATCH,
                opt=dict(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                         total_steps=TRAIN_MESH_STEPS["e"]),
                seed=seed, legs=legs,
                wait=dict(before=TRAIN_MESH_ARCH_LATE[0],
                          path=os.path.join(go_dir, TRAIN_MESH_ARCHS_GO),
                          need_gib=TRAIN_MESH_ARCHS_NEED_GIB["late"]))
    t0 = time.perf_counter()
    ranks = spmd.spawn(mc.card_arch_rank, TP_RANKS, backend="gloo",
                       args=(spec,), timeout=900)
    res = dict(policy="tp_bf16", seq=TRAIN_SEQ, batch=TRAIN_MESH_ARCH_BATCH,
               ranks=TP_RANKS, backend="gloo, one card (not NCCL)",
               spawn_s=time.perf_counter() - t0,
               waited=[r["waited"] for r in ranks])
    res["legs"], bad = train_mesh_archs_gates(legs, ranks)
    launched = {k: v - launches0[k] for k, v in _kernel_launches().items()}
    for r in ranks:
        for k, v in r["kernel_launches"].items():
            launched[k] = launched.get(k, 0) + v
    res.update(kernel_launches=launched,
               phase_s=time.perf_counter() - t_phase, card=card_line())
    log(json.dumps({"train_mesh_archs": {
        k: v for k, v in res.items() if k != "legs"}}))
    if bad:
        raise AssertionError("train mesh archs: " + "; ".join(bad))
    if any(launched.values()):
        raise AssertionError(f"train mesh archs: hand-written kernels "
                             f"launched on the training path: {launched}")
    return res


# ---------------------------------------------------------------------------
# tooling: the card's energy rows, the dry run against the card, examples
# ---------------------------------------------------------------------------
#: each energy loop's measured span (s), after ``ENERGY_SETTLE_S`` of
#: the same loop whose power samples are dropped (``power.draw`` is
#: averaged over about a second)
ENERGY_S = 3.0
ENERGY_SETTLE_S = 1.0
#: square GEMM side and copy size of the energy loops
ENERGY_N = 8192
ENERGY_COPY_BYTES = 2 * 2 ** 30


class PowerSampler:
    """``nvidia-smi --query-gpu=power.draw -lms 100`` in the background:
    ``mean(t0, t1)`` is the mean board power (W) of the samples that
    arrived between two ``time.perf_counter()`` readings."""

    def __init__(self):
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                self.samples.append((time.perf_counter(),
                                     float(line.strip())))
            except ValueError:
                pass

    def mean(self, t0: float, t1: float) -> tuple:
        got = [w for t, w in self.samples if t0 <= t <= t1]
        if len(got) < 5:
            raise AssertionError(f"power sampler: {len(got)} samples "
                                 f"between its readings (need >= 5)")
        return sum(got) / len(got), len(got)

    def stop(self):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def _power_loop(sampler, fn, work: float) -> dict:
    """Runs ``fn`` in synchronized batches of about 0.1 s for
    ``ENERGY_SETTLE_S + ENERGY_S`` seconds; the rate (``work`` units a
    call) and mean power over the last ``ENERGY_S``."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    batch = max(1, int(0.1 / max(time.perf_counter() - t, 1e-6)))
    start = time.perf_counter()
    settle = start + ENERGY_SETTLE_S
    end = settle + ENERGY_S
    done, t_first, t_last = 0, None, None
    while True:
        for _ in range(batch):
            fn()
        torch.cuda.synchronize()
        now = time.perf_counter()
        if now < settle:
            continue
        if t_first is None:
            t_first = now
        else:
            done += batch
            t_last = now
        if now >= end:
            break
    rate = done * work / (t_last - t_first)
    watts, n = sampler.mean(t_first, t_last)
    return {"rate": rate, "watts": watts, "samples": n,
            "seconds": round(t_last - t_first, 3)}


def energy_phase() -> dict:
    """The H100's energy rows for ``core.energy``: board power above idle
    over the achieved rate of a GEMM loop per format (fp32 on CUDA cores
    with TF32 off, bf16, fp16, fp8 by ``torch._scaled_mm``) and of a
    device-to-device copy, with the idle power read before them (whole-board
    figures are printed beside); and the card's memory size for
    ``core.hw``."""
    import torch
    t0 = time.perf_counter()
    assert not torch.backends.cuda.matmul.allow_tf32
    n = ENERGY_N
    flops = 2.0 * n ** 3
    gen = torch.Generator(device="cuda").manual_seed(0)
    sampler = PowerSampler()
    try:
        time.sleep(0.3)
        torch.cuda.synchronize()
        t_idle = time.perf_counter()
        time.sleep(2.0)
        idle_w, idle_n = sampler.mean(t_idle, time.perf_counter())
        rows = {}
        for fmt, dtype in (("fp32", torch.float32),
                           ("fp16alt", torch.bfloat16),
                           ("fp16", torch.float16)):
            a = torch.randn((n, n), generator=gen, device="cuda").to(dtype)
            b = torch.randn((n, n), generator=gen, device="cuda").to(dtype)
            rows[fmt] = _power_loop(sampler, lambda: torch.mm(a, b), flops)
            del a, b
        a = torch.randn((n, n), generator=gen, device="cuda").to(
            torch.float8_e4m3fn)
        bt = torch.randn((n, n), generator=gen, device="cuda").to(
            torch.float8_e4m3fn)
        one = torch.ones((), device="cuda")
        rows["fp8"] = _power_loop(sampler, lambda: torch._scaled_mm(
            a, bt.t(), scale_a=one, scale_b=one,
            out_dtype=torch.bfloat16), flops)
        del a, bt
        src = torch.empty(ENERGY_COPY_BYTES, dtype=torch.uint8,
                          device="cuda").fill_(1)
        dst = torch.empty_like(src)
        copy = _power_loop(sampler, lambda: dst.copy_(src),
                           2.0 * ENERGY_COPY_BYTES)
        del src, dst
    finally:
        sampler.stop()
    gc_cuda()
    above = lambda r: (r["watts"] - idle_w) / r["rate"] * 1e12
    res = {"phase": "energy", "card": card_line(),
           "idle_w": round(idle_w, 2), "idle_samples": idle_n,
           "pj_per_flop": {f: above(r) for f, r in rows.items()},
           "board_pj_per_flop": {f: r["watts"] / r["rate"] * 1e12
                                 for f, r in rows.items()},
           "tflop_s": {f: r["rate"] / 1e12 for f, r in rows.items()},
           "watts": {f: r["watts"] for f, r in rows.items()},
           "pj_per_byte": above(copy),
           "board_pj_per_byte": copy["watts"] / copy["rate"] * 1e12,
           "copy_tb_s": copy["rate"] / 1e12,
           "copy_watts": copy["watts"],
           "samples": {**{f: r["samples"] for f, r in rows.items()},
                       "copy": copy["samples"]},
           "total_memory": torch.cuda.get_device_properties(0).total_memory,
           "phase_s": round(time.perf_counter() - t0, 1)}
    for f, pj in list(res["pj_per_flop"].items()) + [
            ("copy", res["pj_per_byte"])]:
        if not (0 < pj < 1e4):
            raise AssertionError(f"energy: {f} row {pj} pJ is not a "
                                 f"positive finite reading")
    log(json.dumps(res))
    return res


#: the dry run's card check: gemma2-9b's full-width decode step, dense
#: backends, ``batch`` rows against a ``max_len`` cache (decode_32k's
#: length; its batch cut to fit one card beside the serving weights)
DRYRUN_CARD = dict(batch=2, max_len=32768)
#: the step's own peak on the card (``max_memory_allocated`` less the
#: bytes held before it) may differ from the dry run's (its peak less its
#: argument bytes, the one figure of the peak that the dry run measures
#: and does not read off the arguments) by this share of the dry one: the
#: allocator rounds blocks up to 512 bytes, and cuBLAS may take a
#: workspace the dry run cannot see
DRYRUN_PEAK_TOL = 0.01


def dryrun_card_phase(model, params) -> dict:
    """The dry run of gemma2-9b's decode step (meta tensors, the card's op
    path, a one-rank mesh) against the same step on the card with the
    serving phases' weights: flops equal (``FlopCounterMode`` on both),
    argument bytes equal, and the step's own peak (the peak less the
    arguments) within ``DRYRUN_PEAK_TOL`` of the dry run's; the whole
    peak's share is printed, not gated (its argument bytes are the same
    count on both sides)."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.train.serve_step import make_decode_step
    t0 = time.perf_counter()
    b, length = DRYRUN_CARD["batch"], DRYRUN_CARD["max_len"]
    mesh = dryrun.dry_mesh(shape=(1, 1))
    m = model.with_cfg(paged_kv=False, decode_backend="dense",
                       prefill_backend="dense")
    step_d, args_d = dryrun.build_step(m.cfg, "decode_32k", mesh, "tp_bf16",
                                       batch=b, seq=length)
    dry = dryrun.count(step_d, args_d)
    step, _, _ = make_decode_step(m, mesh, batch=b, max_len=length)
    args = (params, torch.zeros((b, 1), dtype=torch.int32, device="cuda"),
            m.init_caches(b, length), length - 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    card = dryrun.count(step, args)
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated() - before
    card_peak = card["memory"]["argument_bytes"] + step_peak
    dry_step = dry["memory"]["peak_bytes"] - dry["memory"]["argument_bytes"]
    del args
    gc_cuda()
    res = {"phase": "dryrun_card", "batch": b, "max_len": length,
           "dry": dry, "card_counted": {k: card[k] for k in (
               "flops", "bytes", "transcendentals", "memory")},
           "card_peak_bytes": card_peak,
           "card_step_peak_bytes": step_peak,
           "dry_step_peak_bytes": dry_step,
           "step_peak_rel_diff": (step_peak - dry_step) / dry_step,
           "peak_rel_diff": (card_peak - dry["memory"]["peak_bytes"])
           / dry["memory"]["peak_bytes"],
           "peak_tol": DRYRUN_PEAK_TOL,
           "phase_s": round(time.perf_counter() - t0, 1)}
    log(json.dumps(res))
    if dry["flops"] != card["flops"] or dry["flops"] <= 0:
        raise AssertionError(f"dry run: {dry['flops']} flops, the card's "
                             f"step {card['flops']}")
    if dry["memory"]["argument_bytes"] != card["memory"]["argument_bytes"]:
        raise AssertionError(
            f"dry run: argument bytes {dry['memory']['argument_bytes']}, "
            f"the card's {card['memory']['argument_bytes']}")
    if dry_step <= 0 or abs(res["step_peak_rel_diff"]) > DRYRUN_PEAK_TOL:
        raise AssertionError(f"dry run: the step's peak {dry_step} vs the "
                             f"card's {step_peak}: "
                             f"{res['step_peak_rel_diff']:.4f} of it, over "
                             f"{DRYRUN_PEAK_TOL}")
    return res


#: the dry-run leg: gemma2-9b decode_32k on both production meshes, in a
#: CPU process of its own beside the build
DRYRUN_CELLS = (("gemma2-9b", "decode_32k", False),
                ("gemma2-9b", "decode_32k", True))


def dryrun_leg_start():
    """Starts the dry-run leg (``python -m repro_torch.launch.dryrun`` on
    the meta device, one process, no card: ``CUDA_VISIBLE_DEVICES`` is
    empty there); returns its join, which gates and returns the records."""
    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    script = ("import json, sys; from repro_torch.launch import dryrun; "
              "json.dump([dryrun.run_cell(a, s, mp, 'tp_bf16') "
              "for a, s, mp in json.loads(sys.argv[1])], "
              "open(sys.argv[2], 'w'))")
    path = os.path.join(out, "cells.json")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", script, json.dumps(DRYRUN_CELLS), path],
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
             "PYTHONPATH": os.path.join(ROOT, "src")},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # a run that fails before the join stops the leg too
    atexit.register(lambda: proc.poll() is None and proc.kill())

    def join() -> dict:
        try:
            text = proc.communicate(timeout=600)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            raise AssertionError(f"dry-run leg failed ({proc.returncode}):"
                                 f" {text[-2000:]}")
        with open(path) as f:
            recs = json.load(f)
        shutil.rmtree(out, ignore_errors=True)
        res = {"phase": "dryrun_leg", "seconds": round(
            time.perf_counter() - t0, 1), "cells": [
            {k: r[k] for k in ("arch", "shape", "mesh", "n_devices", "ok",
                               "memory", "flops", "bytes",
                               "transcendentals", "coll", "times")}
            for r in recs]}
        for r in recs:
            if not r["ok"] or r["flops"] <= 0 or not r["coll"]:
                raise AssertionError(f"dry-run leg: {r['mesh']} record "
                                     f"{r}")
        log(json.dumps(res))
        return res
    return join


#: the example twins run on the card, each in a process of its own, with
#: the text their output must hold
EXAMPLES = (("torch_quickstart.py", (), "GEMM energy on the H100"),
            ("torch_serve_decode.py", ("--decode-backend", "kernel"),
             "kernel launches: decode_attention"))


def examples_phase() -> dict:
    """Runs the example twins on the card; the serving one must have
    launched both attention kernels."""
    t0 = time.perf_counter()
    res = {"phase": "examples", "runs": {}}
    for name, argv, want in EXAMPLES:
        t = time.perf_counter()
        r = subprocess.run(
            [sys.executable, os.path.join(ROOT, "examples", name), *argv],
            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
            capture_output=True, text=True, timeout=300)
        if r.returncode != 0 or want not in r.stdout:
            raise AssertionError(f"example {name} {argv}: rc "
                                 f"{r.returncode}: {(r.stdout + r.stderr)[-2000:]}")
        res["runs"][name] = {"seconds": round(time.perf_counter() - t, 1),
                             "tail": r.stdout.strip().splitlines()[-2:]}
        if name == "torch_serve_decode.py":
            line = [ln for ln in r.stdout.splitlines() if want in ln][0]
            counts = [int(x.strip().split()[-1])
                      for x in line.split(":", 1)[1].split(",")]
            res["runs"][name]["launches"] = counts
            if min(counts) <= 0:
                raise AssertionError(f"example {name}: {line}")
    res["phase_s"] = round(time.perf_counter() - t0, 1)
    log(json.dumps(res))
    return res


def gc_cuda() -> None:
    """Frees what the last phase dropped."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _leaves(tree):
    """The tensors of a parameter tree."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    clock = [time.perf_counter()]
    phase_s = {}

    def lap(name):
        clock.append(time.perf_counter())
        phase_s[name] = round(clock[-1] - clock[-2], 1)

    # the training phases need no kernel: they run on the card while nvcc
    # builds the libraries on the host, the unsharded one in a process of
    # its own (its deterministic-algorithm switch and its profile stay its
    # own), the mesh phases in two threads here
    beside = {}

    def run(*phases):
        try:
            for tag, phase in phases:
                beside[tag] = phase()
                phase_s[tag] = round(beside[tag]["phase_s"], 1)
                gc_cuda()
        except BaseException as e:      # re-raised in the main thread
            beside.setdefault("errors", []).append(e)

    dry_leg = dryrun_leg_start()
    trainer = ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"))
    go_dir = tempfile.mkdtemp(prefix="chip_smoke_train_mesh_archs_")
    try:
        trained = trainer.submit(train_phase)

        def mesh_then_go():
            run(("train_mesh", train_mesh_phase))
            # the MoE arch legs need the card this phase and the unsharded
            # training phase held: started beside the latter's last runs,
            # they ran the card out of memory
            wait_futures([trained])
            open(os.path.join(go_dir, TRAIN_MESH_ARCHS_GO), "w").close()

        # the smaller arch legs beside the fpnew mesh phase from the start
        # (the card holds the three training phases at once), the MoE legs
        # in the same ranks once it and the unsharded phase have ended
        threads = [threading.Thread(
            target=run, name="train_mesh_archs",
            args=(("train_mesh_archs",
                   lambda: train_mesh_archs_phase(go_dir)),)),
            threading.Thread(target=mesh_then_go, name="train_mesh")]
        for t in threads:
            t.start()
        hgmma_gate = build_phase()
        lap("build")
        # the example twins need the built kernels and little of the card:
        # they run while the training phases finish
        examples = threading.Thread(
            target=run, name="examples", args=(("examples", examples_phase),))
        examples.start()
        for t in threads:
            t.join()
        if "errors" in beside:
            raise beside["errors"][0]
        trained.result()
    finally:
        trainer.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(go_dir, ignore_errors=True)
    lap("training_after_build")
    # the energy leg wants the card otherwise idle
    examples.join()
    if "errors" in beside:
        raise beside["errors"][0]
    lap("examples_wait")
    gc_cuda()
    energy = energy_phase()
    lap("energy")
    recs = kernel_phase()
    recs.update(op_kernel_phase())
    op_res = op_path_phase()
    tele = telemetry_phase()
    nonfinite = nonfinite_phase()
    hgmma_gate()
    lap("kernels")
    tuned = autotune_phase()
    lap("autotune")
    model, params = full_model()
    dry_card = dryrun_card_phase(model, params)
    lap("dryrun_card")
    serving = [slice_phase(model, params)]
    lap("slice")
    serving.append(speculative_phase(model, params, serving[0]))
    lap("speculative")
    serving.append(generate_phase(model, params))
    lap("generate")
    fleet_model, fleet_params = prefix_model(model, params, FLEET_LAYERS)
    serving.append(overload_phase(fleet_model, fleet_params))
    lap("overload")
    serving.append(ha_phase(
        fleet_model, fleet_params,
        serving[1]["verify_vs_step"]["logits_max_abs_diff"]))
    lap("ha")
    del fleet_model, fleet_params
    del model, params
    gc_cuda()
    tp = tp_phase()
    serving.append(tp)
    lap("tp")
    gc_cuda()
    serving.append(escalation_phase())
    lap("escalation")
    gc_cuda()
    serving.append(mla_phase())
    lap("mla")
    gc_cuda()
    serving.append(deepseek_phase())
    lap("deepseek")
    gc_cuda()
    serving.append(moe_phase())
    lap("moe")
    gc_cuda()
    granite = granite_phase()
    serving.append(granite)
    lap("granite")
    gc_cuda()
    archs = {}
    for tag, phase in (("gemma3", gemma3_phase),
                       ("internvl2", internvl2_phase),
                       ("whisper", whisper_phase),
                       ("zamba2", zamba2_phase),
                       ("xlstm", xlstm_phase)):
        archs[tag] = phase()
        serving.append(archs[tag])
        lap(tag)
        gc_cuda()
    dry_leg()
    lap("dryrun_leg_wait")
    log(json.dumps({"tooling": {
        "energy_pj_per_flop": energy["pj_per_flop"],
        "energy_pj_per_byte": energy["pj_per_byte"],
        "idle_w": energy["idle_w"], "dryrun_card_flops": dry_card["dry"][
            "flops"], "dryrun_card_step_peak_rel_diff": dry_card[
            "step_peak_rel_diff"], "dryrun_card_peak_rel_diff": dry_card[
            "peak_rel_diff"]}}))
    log(json.dumps({"phase_s": phase_s}))
    launches, variants, by_cluster = dict(op_res["launches"]), {}, {}
    by_dims, by_group, noncausal, by_q_rows = {}, {}, 0, {}
    tuned_picks = {"matmul": op_res["matmul_tuned_picks"]}
    variants.update(op_res["variants"])
    for res in serving:
        for key, total in (("flash_launches_by_q_rows", by_q_rows),
                           ("tuned_picks", tuned_picks)):
            for c, n in res.get(key, {}).items():
                total[c] = total.get(c, 0) + n
        for dims, n in res["flash_launches_by_dims"].items():
            by_dims[dims] = by_dims.get(dims, 0) + n
        for name, n in res["launches"].items():
            launches[name] = launches.get(name, 0) + n
            variants.setdefault(name, {})
            for v, k in res["variants"][name].items():
                variants[name][v] = variants[name].get(v, 0) + k
        for c, n in res["decode_launches_by_cluster"].items():
            by_cluster[c] = by_cluster.get(c, 0) + n
        for g, n in res.get("decode_launches_by_group", {}).items():
            by_group[g] = by_group.get(g, 0) + n
        noncausal += res.get("flash_launches_noncausal", 0)
    line = []
    for name, cases in recs.items():
        main_case = cases[0]
        entry = dict(
            name=name, **KERNELS[name], launches=launches[name],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=main_case["kernel_ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"])
        if name in variants:
            entry.update(launches_by_variant=variants[name])
            if "fma_ms" in main_case:
                entry["fma_ms"] = main_case["fma_ms"]
        entry["nonfinite_cases"] = [
            {k: c[k] for k in ("case", "nan", "inf", "max_abs_err")}
            for c in nonfinite if c["kernel"] == name]
        fma = [c for c in cases if "fma_max_abs_err" in c
               or "fma_max_err_over_tol" in c]
        if fma:
            entry["fma_held"] = [
                {k: c.get(k) for k in ("case", "fma_ms", "fma_max_abs_err",
                                       "fma_max_err_over_tol")}
                for c in fma]
        split = [c for c in cases if c.get("variant") == "split"]
        if split:
            entry["split_cases"] = [
                {k: c.get(k) for k in ("case", "kernel_ms", "fma_ms",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "max_abs_err",
                                       "max_err_over_tol", "flags_ms")}
                for c in split]
        if "flags_ms" in main_case:
            f32 = [c for c in cases if c["case"] in (
                "decode_f32_p64_local", "flash_f32_p64_chunk")][0]
            entry.update(flags_ms=main_case["flags_ms"],
                         f32_pool_case=f32["case"], f32_pool_ms=f32["kernel_ms"],
                         f32_pool_bound_ms=f32["bound_ms"],
                         telemetry_cases=[[t["case"], t["variant"],
                                           t["flags_ms"]] for t in tele
                                          if t["kernel"] == name])
        op = OP_OF_KERNEL.get(name)
        if op is not None:
            entry["tuned_picks"] = tuned_picks.get(op, 0)
            entry["autotune_leg"] = [
                {k: leg[k] for k in ("case", "heuristic", "winner")}
                for leg in tuned["legs"] if leg["op"] == op]
        if name == "tp_matmul":
            entry["launches_by_plan"] = op_res["matmul_launches_by_plan"]
        if name == "decode_attention":
            entry["launches_by_cluster"] = by_cluster
            entry["launches_by_group"] = by_group
            entry["verify_case"] = {
                k: c[k] for c in cases if c["case"] == "decode_bf16_p64_verify"
                for k in ("cluster", "fold_own_cluster", "bitwise_vs_steps",
                          "kernel_ms", "own_cluster_ms", "steps_ms",
                          "bound_ms", "bound_by", "sdpa_nocap_ms")}
        if name == "flash_attention":
            entry["launches_by_q_rows"] = by_q_rows
            entry["launches_by_dims"] = by_dims
            entry["launches_noncausal"] = noncausal
            entry["mla_cases"] = [
                {k: c[k] for k in ("case", "variant", "kernel_ms", "flags_ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "max_abs_err")}
                for c in cases if c["case"].startswith("flash_mla")]
            entry["deepseek_192_case"] = {
                k: c[k] for c in cases if c["case"] == "flash_mla_bf16_192"
                for k in ("variant", "kernel_ms", "fma_ms", "plain_ms",
                          "bound_ms", "bound_by", "library_ms")}
        if name in ("decode_attention", "flash_attention"):
            entry["qwen3_cases"] = [
                {k: c.get(k) for k in ("case", "variant", "cluster",
                                       "kernel_ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "max_abs_err")}
                for c in cases if "qwen3" in c["case"]]
            entry["granite_cases"] = [
                {k: c.get(k) for k in ("case", "variant", "cluster",
                                       "kernel_ms", "flags_ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "max_abs_err", "q_rows", "fma_ms")}
                for c in cases if "granite" in c["case"]]
            entry["tuned_cases"] = [
                [c["case"], c.get("cluster", c.get("q_rows")),
                 c.get("cluster_rule", c.get("q_rows_rule")),
                 c["kernel_ms"], c.get("rule_ms")]
                for c in cases if c.get("cluster_tuned")
                or c.get("q_rows_tuned")]
            entry["granite_launches"] = granite["launches"][name]
            entry["tp_launches"] = tp["launches"][name]
            entry["arch_cases"] = [
                {k: c.get(k) for k in ("case", "variant", "cluster",
                                       "kernel_ms", "flags_ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "max_abs_err", "q_rows", "fma_ms")}
                for c in cases if any(a in c["case"] for a in (
                    "gemma3", "internvl2", "whisper", "zamba2"))]
            entry["arch_launches"] = {tag: res["launches"][name]
                                      for tag, res in archs.items()}
        line.append(entry)
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
