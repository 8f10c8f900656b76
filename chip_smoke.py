#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each raises on failure; nothing falls back to the CPU):
  1. build every CUDA kernel of the main paths from src/repro_torch/kernels/csrc
     with nvcc (one process per source, all at once) and print the ptxas
     register/shared-memory report;
  2. B1, the fused DSBP GEMM, against its plain PyTorch version on the card at
     the llama-7b projection shapes (decode M=4 and prefill M=512): bit-equal;
     kernel, plain and bound times;
  3. B2, flash attention, against its plain version at prefill (B=4, S=512,
     ragged lengths) and decode (per-row positions), at llama-7b's width
     (H=32, D=128), gemma3-12b's (Hq=16, Hkv=8, D=256), gemma3-12b's
     heads at D=320 and D=512 (no config has them: the kernel of one warp
     per query row above 256) and mixtral-8x7b's (Hq=32, Hkv=8, D=128), with head and
     row slices bit-equal to the whole call and torch's
     scaled_dot_product_attention timed on the same work, cold, as a
     yardstick;
  4. a CROSS_LAYERS-layer model (1 layer) at full llama-7b width, the same
     packed weights served once on the CPU (plain versions) and once on the
     card (kernels): logits within tolerance, greedy tokens equal;
  5. full-width 32-layer llama-7b-paper with random weights from a seeded
     torch.Generator, packed "precise": one ragged Engine.generate of 4
     prompts and Engine.serve of 8 requests through 4 slots, with each
     kernel's launch count over that run and every sampled batch recorded
     (for phases 15 and 17); then a
     torch.profiler trace of four decode steps: device time of B1, B2 and
     everything else, and the card's idle share;
  6. B3, the standalone input path, against its plain version: bit-equal at
     M in {4, 512} x K in {4096, 11008}, e5m2, fixed and trunc, timed cold;
     then the launch floor, an empty kernel timed the same way;
  7. B4, the grouped integer GEMM, against its plain version at the
     projection shapes (M=4 and 512), folded and unfolded: bit-equal, one
     order for both forms, so folded == unfolded; timed cold; and B3+B4
     against B1 (within 3e-5 * max|y|: the scale folds run in another
     order);
  8. B5, packed-KV flash attention, against B2 over dequantize() (bit-equal:
     one source, pow2 folds) and its plain version (1e-5), at decode (B=4,
     H=32, S=2048, ragged), a 128-query chunk at q_pos0 > 0, and
     gemma3-12b's decode (Hq=16, Hkv=8, D=256, 320 and 512);
  9. the model of phase 4 served with kv_quant="kv8",
     quant_method="dsbp_kernel": CPU vs card greedy tokens equal, and on the
     card packed-KV serving equal token for token to serving over a float
     cache whose every write is quantized then dequantized;
  10. the full-width model of phase 5 with kv8 + dsbp_kernel (generate +
     serve, launch counts of B2-B5 per step and prefill, bytes per token,
     zero weight relayouts and zero KV dequantizes dispatched by a decode
     step, and a torch.profiler trace of four decode steps: device time of
     B3, B4, B5 and everything else, and the idle share), then serve with
     kv8 + the default dsbp_fused;
  11. B6 and B7, paged flash attention over a float / packed block pool,
     against B2 / B5 over the gathered dense view (bit-equal: one source,
     only a key row's address changes) and their plain versions (1e-5), at
     phase 13's shape (8 lanes, H=32, D=128, bs=16, 32 blocks per table,
     shared prompt blocks, idle all-scratch lanes and a chunk lane at
     kv_len 1), at decode (B=4, ragged lengths up to 2,048, shuffled
     tables with and without shared blocks), a 16-query chunk at q_pos0 > 0
     with a partial last block, and gemma3-12b's decode (Hq=16, Hkv=8,
     D=256, 320 and 512); times beside the gather + SDPA yardstick, bounds
     from the distinct key rows read;
  12. a PAGED_CROSS_LAYERS-layer model (2 layers, so each layer's cache
     and block-table indexing is compared across devices) at full
     llama-7b width served paged (a shared-prefix group and a chunked
     prompt), float pool and kv8 pool, on the CPU (plain versions) and on
     the card (kernels): greedy tokens equal under the near-tie rule of
     phase 9;
  13. the full-width model of phase 5 served paged: 8 requests sharing a
     192-token system prompt plus 2 chunked 320-token prompts, 8 lanes on
     the KV blocks of 4 dense slots (129 blocks of 16), float pool and then
     kv8; tokens and the logits they were drawn from held against a dense
     serve of the same requests at batch 8 (phase 9's rule), and exactly
     against a dense serve where the batches match; scheduler stats, B6/B7
     launched 32 times per decode step, and 0 KV-sized gathers and 0 KV
     dequantizes dispatched by a paged decode step;
  14. B8, the sharded fused GEMM, on a (1, 2) mesh of two rank processes
     sharing the card (gloo): at the decode (M=4) and prefill (M=512)
     shapes of wq and w1 (column-parallel) and wo and w2 (row-parallel,
     K=11008 for w2), each rank's output assembled and held against B8's
     plain version (B1's over the whole weight) on the same inputs, and
     against B1 on the whole weight (bit-equal for column-parallel;
     bit-equal or within 4 ulps for row-parallel, the counts printed); the
     whole call's time on rank 0, B1's on its shard, one all_reduce of the
     output, the plain version's and the bound (the whole weight's bytes:
     both ranks read through the one card);
  15. full-width llama-7b-paper on a (1, 2) mesh (tensor-parallel), phase
     5's seed and traffic through generate and serve at 4 slots: every
     sampled batch (recorded in the run, as phase 5's)
     held against phase 5's: equal tokens and bit-equal logits; launches
     per rank (B8 and B1 on every projection's shard, B2 on 16 heads per
     rank), collectives per decode step, peak memory per rank; 15b. the
     same at 2 layers on a (2, 2) mesh (data- and tensor-parallel, 4
     ranks) against one device: equal tokens, logits within
     MESH_DATA_REL * max|logit|.
  16a. the models of phase 4 served speculatively (spec_k 3, the
     draft through dsbp_fused) on the CPU (plain versions) and on the card
     (kernels): tokens equal under phase 9's near-tie rule, the same
     accepted-length histogram where no near tie was taken; then on the
     card with the JAX default draft method dsbp_ref (the plain integer
     path), its time per round beside dsbp_fused's;
  16. self-speculative decoding at full width: B1 over draft_view
     containers bit-equal to plain at the draft's decode shapes and the
     verify's; the time of deriving every projection's draft view and the
     narrow kv8 view at full depth; then a SPEC_LAYERS-layer (8) model of
     phase 5's seed served with phase 5's traffic with spec_k 3 and
     spec_draft_method dsbp_fused at spec_draft_bits 4 and 7, then kv8
     with kv_draft_bits 6 (the narrow view's bytes and time), then phase
     13's paged traffic on a float and a kv8 pool; each held against the
     same engine with spec_k 0 under phase 9's rule on the logits both
     serves drew each token from (the verify pass batches its reductions
     otherwise), with zero extra weight bytes and the engine's containers
     untouched, B1 launched at M = lanes in every draft step and M = 4 *
     lanes in every verify, and B2 / B5 / B6 / B7 launched n_layers times
     in every draft step; accepted_hist, mean_accepted, ms per round and
     per committed token beside the spec_k 0 serve's, peak memory.
  17a. the DSBP policy loop on CROSS_LAYERS layers at full width, CPU
     (plain) vs card (kernels): calibration reports with equal counts, flops and
     weight-side statistics and input histograms within HIST_TOL; scores of
     a decided synthetic BoolQ subset under a mixed policy (four presets
     cycling over the projection paths, KV units.0 at kv4) within
     SCORE_TIE; that policy's serve under phase 9's rule;
  17. the policy loop at full width and depth: calibrate (4 batches of
     4 x 128 tokens; seconds, flop shares, nz_frac, peak memory); price
     every uniform rung of both ladders on the paper's macro model; gold
     labels from the raw float model on 64-item synthetic BoolQ and
     Winogrande, then autotune over the input ladder (6, 4, 3, 2) with
     max_drop 0 (trials, seconds, the policy, accuracies); serve phase 5's
     traffic under a uniform 'precise' policy (every sampled batch
     bit-equal to phase 5's), the mixed policy with its kv4 cache and the
     autotuned one (ms per step, tokens/s, peak memory, B1 = 224 and the
     attention kernel = 32 launches per decode step, B1 bit-equal to plain
     on a served container of each config); a row's score alone vs among
     copies of itself and vs in a batch of other rows; B1 under every rung
     and B5 at kv4 timed cold; a `policy (phase 17):` JSON line.
  18. fault-tolerant, observable serving on phase 5's model: (a) phase 5's
     traffic observed, under numeric_guard 'quarantine', and both, tokens
     bit-equal to phase 5's, one guard check per decode step and admission,
     every request 'ok' with a complete span tree, the metrics snapshot
     round-tripping, TTFT / total / tokens/s per request, ms per decode step
     of each beside phase 5's, and device kernels per decode step of the
     engine's own step (observe: as many as without; the guard: at most 2
     more, its finiteness reduction); (b) NaN plans under 'quarantine',
     'fallback' (transient and persistent) and 'fail-fast', a cancel and a
     deadline; (c) phase 13's traffic and pool, float then kv8, under
     FaultPlan.seeded(5, ...): a status for every uid, no lost request,
     invariant checks after every iteration, the recorder's fault tally
     equal to the plan's, the same trace when the plan replays; (d) phase
     16's dense traffic at draft bits 7 under spec-mismatch rounds and a NaN
     round; (e) QuantHealth.sample_cache over full-width float and kv8
     caches (timed), a NaN in one layer's K named as entry units.0, and a
     uniform 'precise' policy repriced from that trip.  Every stream is
     held to its fault-free reference under phase 9's rule (a stream that
     ended early against the reference's head); one `robust (phase 18):`
     JSON line per case.
  19. the Griffin hybrid, last: B1 at recurrentgemma-2b's and gemma3-12b's
     decode shapes and B2 (prefill with the window, decode on a wrapped
     ring: kv_len past the ring bit-equal to kv_len = S_c), B5, B6 and B7
     at Hq 10, Hkv 1, D 256 against their plain versions, timed cold;
     19a, recurrentgemma-2b at full width and 3 layers (rglru, rglru,
     attn_local) with window 64, CPU (plain) vs card (kernels) under phase
     9's rule; 19, recurrentgemma-2b at full width and depth (26 layers,
     seeded weights, packed "precise", max_len 4096, so S_c 2048 on the
     local layers): generate of 4 prompts (64 / 700 / 2100 / 2600 tokens)
     and serve of 8 requests through 4 slots at full depth, then the
     first HYBRID_SUB_LAYERS (8) layers of the same seed at full width:
     the same serve, with kv8, paged (bs 16, 6 requests sharing a
     192-token prefix and 2 chunked prompts past the window) float and
     kv8, with every kernel's launches over those runs; the float model's
     ring decode past the window held to Model.prefill_trunk over the
     whole context (RING_REL), at 8 layers paged held to dense at matched
     batches token for token (float, kv8, and spec_k 3 over the tokens
     committed before any lane can finish), a planted rollback fault
     (undo_draft skipped) that must fail the speculative match, B1 = 164
     (counted by (K, N) against the containers) and B2 = 8 launches per
     decode step at full depth, B5 = 2 at 8 layers, spec_k 3 at draft
     bits 7 dense and paged against spec_k 0 (HYBRID_TIE) at 8 layers, one
     NaN step under 'fallback' bit-equal to the unfaulted serve at full
     depth; prefill s, ms per step,
     KV bytes, peak memory, a torch.profiler trace of two decode steps
     and the wa / wx weight-only products' time per step; 19b, gemma3-12b
     at full width and 6 layers (5 local at window 1024, 1 global),
     max_len 2048: local and global rings in one block table, paged ==
     dense, B1 launches per decode step by (K, N); a `hybrid (phase 19):`
     JSON line.
  20. the MoE family, after 19: B1 at mixtral-8x7b's decode shapes (wq /
     wo K=4096 N=4096, wk / wv K=4096 N=1024) against its plain version,
     timed cold; 20a, mixtral-8x7b at full width and 2 layers: the
     streamed packed init (init(pack=), drawn and packed one layer at a
     time) bit-equal to init followed by pack_weights_int8, and the
     model's generate of MOE_CROSS_NEW tokens on the CPU (plain versions)
     and the card (kernels) under phase 9's rule; 20, full width and depth (32 layers,
     ~187 GB of f32 draws packed into ~51 GB as they are drawn; the init's
     peak gated below the packed model plus two f32 layers): generate and a
     dense serve of phase 5's traffic, each kernel's launches over that
     run, B1 = 128 (wq wk wv wo, counted by (K, N) against the containers;
     the experts are weight-only, as in the reference) and B2 = 32 per
     decode step, the MoE FFN of one decode step and its expert
     dequantizes timed, prefill s, ms per step, peak memory and a
     torch.profiler trace of two decode steps; 20b, full width at
     MOE_SERVE_LAYERS layers: kv8 (B5), paged float and kv8 (B6 / B7, one
     launch per layer and decode step), paged == dense token for token at
     matched batches (float, kv8, and spec_k 3 over the tokens committed
     before any lane can finish), spec_k 3 at draft bits 7 against spec_k
     0: the float model's under phase 9's rule, the packed model's under
     MOE_TIE, which a planted acceptance fault (every draft kept, so
     rejected drafts stay in the cache) must fail; the cause behind
     MOE_TIE counted: the top-2 routes of verify passes that flip against
     the chained decode steps over the same tokens, and the logit
     difference with and without a flip; a `moe (phase 20):` JSON line.
  21. the SSD family, after 20: B1 at mamba2-370m's shapes (w_in K=1024
     N=4384, w_out K=2048 N=1024) at M 4 and 2048 (w_in's prefill tile
     ends in a partial column block of 32) against its plain version,
     timed cold; 21a, mamba2-370m at full width and 2 layers, packed
     "precise" from one seed, on the CPU (plain versions) and the card
     (kernels): generate's logits within KV_TIE, generate's and a serve's
     tokens under phase 9's rule; 21, full width and depth (48 layers,
     d_inner 2048, 32 SSD heads of 64, state 128, tied embeddings over a
     vocab padded to 50,432), drawn and packed by init(pack=), max_len
     1024, prefill_bucket 128 (the SSD chunk, which every padded prompt
     batch must be a multiple of): generate of 4 prompts (37 / 130 / 300 /
     500 tokens: several chunks and a carried state), a dense serve of 8
     requests through 4 slots, the same with kv8 (token-equal: nothing to
     quantize), paged (no pool, kv_blocks 0, a 600-token prompt in chunk
     steps) under phase 9's rule against the dense serve, paged == dense
     token for token at matched batches, spec_k 3 at draft bits 7 against
     spec_k 0 under phase 9's rule; the float model's paged serve
     against its dense serve within RING_REL at SSD_FLOAT_LAYERS (8)
     layers, which two planted commit faults must fail; B1 = 96 per
     decode step (48 at each
     shape, counted by (K, N) against the containers) and no attention
     kernel launched; prefill s, ms per step, peak memory, a
     torch.profiler trace of two decode steps; an `ssd (phase 21):` JSON
     line.
  22. the modality frontends, last: B1 at musicgen-large's decode shapes
     (M 4: K=2048 N=2048 / 8192, K=8192 N=2048) and llava-next-34b's (M 2:
     K=7168 N=7168 / 1024 / 20480, K=20480 N=7168) and at llava's prefill M
     (2 rows x 3,008 positions; the plain version over row blocks of
     PLAIN_ROWS) bit-equal to plain, B2 at musicgen's MHA D 64 and llava's
     GQA 56 : 8 D 128 over its ~3,000-position prompt, prefill and decode,
     within 1e-5, B5 at both decode shapes over kv8 K/V bit-equal to B2
     over dequantize() and within 1e-5 of plain, all timed cold; 22a,
     musicgen-large at full width and 2 layers and llava-next-34b at full
     width and 1 layer with its image prefix cut to 128 tokens, float,
     packed "precise" and float over a kv8 cache, a ragged
     generate on the CPU (plain versions) and the card (kernels) under
     phase 9's rule per codebook; 22, musicgen-large at full width and
     depth (48 layers, ~3.22e9 parameters) drawn and packed by
     init(pack=) (each init's peak gated below packed + one f32 layer +
     pack_weights' transient of the widest matrix, measured first):
     generate of 4 ragged (B, L, 4) prompts of 16-128 frames,
     16 new frames, float KV then kv8: output (4, 16, 4), B1 336 per decode
     step by (K, N) and B2 (B5) 48, counted in every decode step of the
     runs themselves, kv8's first sampled batch bit-equal to float's; 22b,
     llava-next-34b at full width and depth (60 layers, ~33.5e9
     parameters) by init(pack=): generate of 2 rows of 2,880 seeded image embeddings + 32 / 128
     text tokens, 8 new tokens, max_len 3,072, float KV then kv8: B1 420 per
     step by (K, N), B2 (B5) 60, peak memory gated below packed + two f32
     layers + the cache + the prefill's K/V and activations, a 2-step
     trace; prefill s, ms per step, peak memory; a `frontends (phase 22):`
     JSON line.
  23. the bfloat16 dtype, last: B2, B5, B6 and B7 on bf16 operands
     (llama-7b's prefill and decode, phase 8's kv8 decode, phase 13's
     paged lanes, recurrentgemma-2b's MQA D 256 decode) bit-equal to the
     same kernel's f32 instantiation on the exact upcasts rounded once,
     within BF16_PLAIN_REL of their plain versions, timed cold beside SDPA
     in bf16; 23a, llama-7b-paper in bf16 at full width and CROSS_LAYERS
     layers, packed, CPU vs card, float KV and kv8, under phase 9's rule
     at the bf16 near-tie bound (BF16_TIE_ULPS); 23, llama-7b-paper in
     bf16 at full width and depth by init(pack=) (peak gated): phase 5's
     traffic through generate and serve, float KV then kv8, B1 224 and B2
     (B5) 32 in every decode step, all attention launches bf16, KV bytes
     per token half of phase 5's, a 2-step trace; at SPEC_LAYERS layers
     (full width), phase 13's paged traffic on a float and a kv8 pool
     (paged == dense at matched batches; the drift to the dense batch-8
     serve within BF16_KV_TIE) and spec_k 3 against spec_k 0; 23b, a bf16
     generate of
     recurrentgemma-2b, mixtral-8x7b, mamba2-370m, musicgen-large and
     llava-next-34b at full width, cut in depth (BF16_FAMILIES), CPU vs
     card; a `bf16 (phase 23):` JSON line.
  24. the training path, last: 24k, the training Functions on the card:
     B2's autograd function at llama-7b's prefill (B 4, H 32, S 512, D
     128, ragged kv_len; output and q / k / v gradients within 1e-5 of the
     plain version's autograd) and the straight-through products of
     'dsbp_fused' (B1) and 'dsbp_kernel' (B3 + B4) at the three projection
     shapes and phase 24's 2,048 rows (forward bit-equal to the kernels'
     plain versions, gx / gw bit-equal to the formula's f32 products and
     within f32_dot_rel in norm of float64 on the card);
     24a, llama-7b-paper at full width and CROSS_LAYERS layers, one train
     step of 2 x 64 tokens on the CPU (plain versions) and the card
     (kernels), float (every gradient within TRAIN_FLOAT_REL of its norm)
     and "precise" through dsbp_fused (packed per call; losses under phase
     9's bound, gradients within TRAIN_GRAD_REL, which must lie above the
     card's own step from weights one ulp away and below each of three
     planted faults; the products' inputs that round to another FP8 value
     on the two sides counted); 24, full width and TRAIN_LAYERS (4) layers
     in f32 with remat, 4 x 512 tokens of the synthetic stream per step: a
     Trainer of 8 steps without checkpoints (the loss finite and falling,
     B1 56 and B2 8 launches per step (each layer's forward runs twice
     under remat), ms per step, tokens/s, peak memory gated below
     TRAIN_PEAK_GIB), a Trainer of 4 steps saving step 4
     (checkpoint.store) and one restored from it running to 8, their
     losses and the final parameters equal to the first's bit for bit
     (deterministic algorithms on: the embedding gather's backward), each
     save and restore timed; a one-step trace (B1, the straight-through
     backward, the attention backward, the optimizer, the rest, idle
     share); 4 bf16 steps (finite, peak); the step-8 checkpoint restored
     into a fresh model (store.restore), bit-equal to the trained one,
     packed "precise" and served through
     generate; a `train (phase 24):` JSON line.
  25. the eleventh config and the copied configs at full width: 25k, B1 at
     every (K, N) of yi-9b, phi3-medium-14b, deepseek-coder-33b and
     grok-1-314b that no earlier phase held (M 4: K=4096 N=512; K=5120
     N=5120 / 1280 / 17920, K=17920 N=5120; K=7168 N=19200, K=19200
     N=7168; K=6144 N=6144 / 1024) and one wide shape of each at M 512,
     bit-equal to plain, and B2 at their new head layouts (Hq : Hkv 48 : 8,
     32 : 4, 40 : 10; D 128) at prefill and decode within 1e-5 of plain,
     all timed cold beside SDPA; 25m, the DCIM circuit models on the card
     (core.mpu, core.fiau, core.mac_array) over a seeded 512 x 4,096
     input: the MPU's widths equal to the CPU's integer for integer and
     within one level of B3's bits (agreeing on >= CIRCUIT_AGREE of the
     groups), the FIAU's reads equal to the CPU's and to
     align_group('trunc'), the MAC array's sums at each weight width equal
     to the CPU's and to an integer matmul; 25a, phi3-medium-14b at full
     width and 1 layer, packed, a ragged generate of short prompts on the
     CPU (plain versions) and the card (kernels) under phase 9's rule; 25,
     each config drawn and packed by init(pack=) from a seed and freed
     before the next: yi-9b, phi3-medium-14b and deepseek-coder-33b at full
     depth (48, 40, 62 layers) and grok-1-314b at GROK_LAYERS (4) of its
     64 (full depth, ~346 GB packed, waits for the expert axis): phase 5's
     traffic through generate and a dense serve, B1 = 7 * L (dense) or 4
     * L (grok: its experts are weight-only) and B2 = L launches in every
     decode step (B1 counted by (K, N) against the containers), the init's
     peak gated below packed + one f32 layer + pack_weights' transient of
     the widest matrix and the runs' below packed + two f32 layers + the
     cache, the prefill's K/V and activations, prefill s, ms per step,
     tokens/s; grok's MoE FFN of one decode step and its expert
     dequantizes timed; a `configs (phase 25):` JSON line.
  26. training beyond the dense family, at full width, f32, "precise"
     through dsbp_fused with remat, on the synthetic stream: 26k, B2's
     autograd function at the families' head layouts (recurrentgemma-2b's
     MQA 10 : 1 at D 256 past its 2,048-key window, mixtral-8x7b's GQA 32
     : 8 under its window, musicgen-large's MHA at D 64, llava-next-34b's
     GQA 56 : 8 over 2,880 image + 128 text positions; output and q / k /
     v gradients within 1e-5 of the plain version's autograd, the forward
     timed cold beside plain and SDPA, forward + backward beside SDPA's)
     and 'dsbp_fused''s straight-through product at one new (K, N) per
     family at the phase's rows (forward bit-equal to plain, gx / gw to
     the f32 products; B1 timed there); 26a, each family at one layer
     (recurrentgemma-2b one pattern unit, llava's image prefix cut to 64)
     CPU (plain) vs card (kernels), one step of 2 x 64 tokens, float and
     "precise" under 24a's rule (the QAT limit read against the card one
     ulp away and three planted faults on the family's own product), MoE
     choices that differ between the sides counted; 26, a Trainer of 5
     steps per config at FAMILY_TRAIN's depth (recurrentgemma-2b 3 layers,
     mixtral-8x7b 1, mamba2-370m all 48, musicgen-large 4, llava-next-34b
     1 at batch 1): losses finite and a held-out batch's loss lower after
     the last step than before the first, B1 and B2 launches counted in
     every step, ms per step, tokens/s, peak memory gated (mixtral and
     llava under the lock); mamba2-370m saving at step 3 and a run
     restored from it bit-equal to the unbroken run; 2 bf16 steps of
     mamba2-370m (finite, peak); a `train-families (phase 26):` JSON line.
  The ranks of 14-15 time-slice the one card: their step times are not
  multi-card numbers.  16, 18, 17a and 17 run after 13, before 14-15b,
  for which the models are freed; 4, 9 and 16a run last.
Run order: 1, then every kernel-timing phase alone on the card (2, 3, 6,
7, 8, 11, then the kernels of 19-23, 25k / 25m and 26k in a second
process of this script while the first waits); then the two processes
share the card, the first running 5, 10, 12, 13, 16, 18, 17a, 17,
14-15b, 25's phi3-medium-14b and deepseek-coder-33b, 26's mixtral-8x7b
and llava-next-34b (FAMILY_FIRST), then 4, 9, 16a, 25a and llava's 26a
(the one-layer checks, mostly on the CPU), the second 20, 22, 25's
grok-1-314b, 26's recurrentgemma-2b, 25's yi-9b, 21, 19, 23, 24, 26's
mamba2-370m and musicgen-large, and 26a of the other four.  A phase whose peak
passes ~25 GiB (17a-17, 14-15b, 25, 20, 22, 26's recurrentgemma-2b,
mixtral-8x7b and llava-next-34b) holds a lock file, so at most one of
them runs at a time and the two fit in the card's 80 GB.  Step times, traces and idle shares of the
shared part are taken with the other process on the card and its host;
kernel times never are.  The second process's output is printed when it
ends, before the kernels' record; a failure of either process fails the
run, and the first stops the second on its way out.
Prints the kernels' JSON record, the card's name and power limit, and last
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device.

    python3 chip_smoke.py --hybrid

runs phases 1 and 19 alone.

    python3 chip_smoke.py --moe

runs phases 1 and 20 alone.

    python3 chip_smoke.py --ssd

runs phases 1 and 21 alone.

    python3 chip_smoke.py --frontends

runs phases 1 and 22 alone.

    python3 chip_smoke.py --bf16

runs phases 1 and 23 alone.

    python3 chip_smoke.py --train

runs phases 1 and 24 alone.

    python3 chip_smoke.py --configs

runs phases 1, 25k, 25m, 25a and 25 alone.

    python3 chip_smoke.py --train-families

runs phases 1, 26k, 26 and 26a alone.

    python3 chip_smoke.py --cross

runs phases 1, 4, 9 and 12 alone (llama-7b-paper's CPU-vs-card checks).

    python3 chip_smoke.py --mesh-only

runs phases 1, 5 and 14-15b alone; on a machine with a card per rank the
ranks get one each and NCCL (the ranks of phase 15b need four).

    python3 chip_smoke.py --kernels

runs phases 1-3, 6-8 and 11 alone: every kernel against its plain version,
and its times.

    python3 chip_smoke.py --spec

runs phases 1, 4, 5, 13 (the references of phase 16), 16a and 16 alone.

    python3 chip_smoke.py --policy

runs phases 1, 5 (the reference of phase 17), 17a and 17 alone.

    python3 chip_smoke.py --robust

runs phases 1, 5, 13 (the references of phase 18) and 18 alone.

Kernel times are cold: each timed loop cycles through copies of the
operands that a call reads (weights, K/V, pools) that together overflow
the 50 MB L2 twice, so every call reads them from device memory, as on the
main path, where ~7 GB of weights pass between two calls of one kernel.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, fp16
# tensor-core operations/s (the exact-integer DSBP MAC's type on Hopper, see
# csrc/dsbp_fused.cu), f32 FMA-pipe operations/s (the attention kernel's type)
HBM_BPS = 3.35e12
FP16_OPS = 989e12
F32_OPS = 67e12
# B3's f32/int operations per element (quantize, fields, shift, align), an
# estimate for its operations bound; its bytes bound it by far
B3_OPS_PER_ELEM = 16
LLAMA_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))  # (K, N): wq.., w1/w3, w2
L2_BYTES = 50 * 2**20
# ~0.5 ms of the SM clock per timed call: more than a wrapper's host work
SLEEP_CYCLES_PER_CALL = 10**6
TIE = 1e-3  # logit tolerance, relative to max|logit|
# a data-split mesh against one device (phase 15b): the split changes the
# row count of the float lm_head GEMM (and of B2's launches), whose library
# kernel may then sum in another order; ulp-level differences (3.4e-7 of max|logit| on an H100,
# PERF.md), where a fault (a rank-local input scale, a wrong fold) moves
# logits by whole percents
MESH_DATA_REL = 1e-5
# CPU vs card decode logits (phase 9): the attention kernels differ from
# their plain versions in the last bits (sum order, expf), and such a bit
# can move one projection input across an FP8 rounding boundary, which the
# following layers compound (phase 9's kv8 run does so at its second decode
# step: 4.7% of max|logit| over 2 full-width layers, PERF.md); so can a
# batch of other rows on one device (phase 13: they move the per-tensor
# input scale, which changes how the smallest inputs round); a kernel or
# cache fault gives differences of the order of max|logit| itself
KV_TIE = 0.1
# a float model's ring decode against its sequence mode over the whole
# context at full width (phase 19): JAX's CPU test holds 2e-4; on the card
# the attention kernels sum in another order than the prefill, over 26
# layers of random weights
RING_REL = 1e-3
# phase 19's speculative serves against spec_k 0 (a verify pass of 16 rows
# vs decode steps of 4): recurrentgemma-2b at full depth on random weights
# has flat logits (max|logit| ~5), and two equally valid FP8 roundings of
# its inputs (other rows in a per-tensor scale) moved them by up to 0.21
# of max|logit| on an H100 (PERF.md, phase 19).  The strict checks are
# elsewhere: paged == dense at matched batches token for token, plain and
# speculative, which a planted rollback fault (run in every phase 19) must
# fail, and the float model's ring decode within RING_REL of its sequence
# mode
HYBRID_TIE = 0.3
# phase 20b's packed speculative serve against spec_k 0 (mixtral-8x7b, 4
# layers, random weights, max|logit| ~4.5): the verify pass quantizes 16
# rows under one per-tensor input scale where a decode step quantizes 4,
# and an input rounded otherwise can flip a token's top-2 routing at a
# near tie, which swaps a whole expert's output for that token (0.19 of
# max|logit| on an H100, PERF.md).  Phase 20b counts those flips between a
# verify pass and the decode steps it stands for (on an H100: 2 of 512
# routes; 0.019 of max|logit| where none flipped, which it holds to
# KV_TIE, and up to 0.28 after a flip), and a planted acceptance fault
# must fail the rule at this bound (it moved a row by 1.02).  The same serves of the float
# model, where no input is quantized, are held to phase 9's rule (KV_TIE);
# the packed rounds are held exactly at matched batches (dense == paged)
MOE_TIE = HYBRID_TIE
# phase 21's packed serves against the dense spec_k 0 serve (mamba2-370m,
# 48 layers of random weights): a paged chunk step quantizes a 128-token
# slice of a prompt beside the other lanes' rows, where the dense prefill
# quantizes the whole padded prompt at once, and a verify pass 16 rows
# where a decode step quantizes 4; each per-tensor input scale then
# rounds every FP8 input otherwise, through 48 layers: on an H100 the
# chunked 600-token prompt's first logits moved by 0.15 of max|logit|,
# the speculative rows by 0.10 (PERF.md, phase 21).  The strict checks
# are elsewhere: paged == dense token for token at matched batches, and
# the float model's paged serve (its chunk steps through the verify path)
# within RING_REL of its dense serve (7.8e-6 on the H100), which two
# planted commit faults must fail (by more than max|logit|)
SSD_TIE = HYBRID_TIE
# the depth phase 16's speculative serves run at (full width; phase 18d
# serves speculation at full depth); and the layers of the CPU-vs-card
# models of phases 4, 9, 12, 16a and 17a (full width): cut for the
# script's time limit, where the CPU's plain versions take most of it
SPEC_LAYERS = 8
CROSS_LAYERS = 1
# phase 12 keeps two layers: the one CPU-vs-card check at full width whose
# per-layer caches and block tables are indexed past layer 0
PAGED_CROSS_LAYERS = 2
# the depth of phase 19's kv8, paged, matched-batch, planted-fault and
# speculative serves (recurrentgemma-2b at full width: 2 units of (rglru,
# rglru, attn_local) and the 2-layer recurrent tail), and of phase 21's
# float paged-vs-dense check and its planted faults (mamba2-370m): cut for
# the script's time limit once phase 22 joined it; phase 19's generate,
# serve, fallback and trace and phase 21's packed serves stay at full depth
HYBRID_SUB_LAYERS = 8
SSD_FLOAT_LAYERS = 8


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# the two processes of a whole run (the run order in the docstring)
# ---------------------------------------------------------------------------

# where the two processes meet: the lock file, the second's log and record
# (build/ is the checkout's own build directory, which .gitignore lists)
RUN_ROOT = Path(__file__).resolve().parent / "build" / "chip_smoke"


@contextlib.contextmanager
def heavy_phase(run_dir):
    """Holds the lock of the phases whose peak passes ~25 GiB, so that no two
    of them share the card's 80 GB; ``run_dir`` None (one process): no lock."""
    if run_dir is None:
        yield
        return
    import fcntl

    with open(run_dir / "heavy.lock", "w") as f:
        t0 = time.perf_counter()
        fcntl.flock(f, fcntl.LOCK_EX)
        waited = time.perf_counter() - t0
        if waited > 1:
            print(f"  [waited {waited:.0f} s for the other process's memory-heavy phase]")
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _jsonable(o):
    """json's fallback for the record the second process hands over: numpy
    and torch scalars as numbers, anything else as the printed lines have it."""
    try:
        return o.item()
    except (AttributeError, ValueError, RuntimeError):
        return str(o)


class Families:
    """The second process of a whole run: phases 19-26,
    started with ``--families-worker``; its output goes to a log, printed
    when it ends."""

    def __init__(self, run_dir: Path):
        self.run_dir = run_dir
        self.log_path = run_dir / "families.log"
        self.printed = False
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-u", str(Path(__file__).resolve()), "--families-worker",
                 str(run_dir)], stdout=log, stderr=subprocess.STDOUT)

    def print_log(self) -> None:
        if not self.printed:
            self.printed = True
            print("== the second process (phases 19-26), its output:")
            print(self.log_path.read_text().rstrip())
            print("== the second process's output ends")

    def check(self) -> None:
        """Raises as soon as the second process has failed."""
        rc = self.proc.poll()
        if rc not in (None, 0):
            self.print_log()
            raise RuntimeError(f"the second process (phases 19-26) failed with "
                               f"exit code {rc}")

    def wait_kernels(self) -> None:
        """Waits while the second process times its kernels alone on the card."""
        while not (self.run_dir / "kernels.done").exists():
            self.check()
            if self.proc.poll() == 0:
                raise RuntimeError("the second process ended before its kernel phases")
            time.sleep(0.2)

    def finish(self) -> dict:
        """Waits for the second process, prints its output and returns its
        record (the bf16 kernels keyed by (kernel, case) again)."""
        self.proc.wait()
        self.print_log()
        self.check()
        rec = json.loads((self.run_dir / "families.json").read_text())
        rec["bf"]["kernels"] = {tuple(k.split("|")): v for k, v in rec["bf"]["kernels"].items()}
        return rec

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
            self.print_log()


def cuda_ms(fn, args_list, iters: int, warmup: int = 2,
            sleep: int = SLEEP_CYCLES_PER_CALL) -> float:
    """Mean device time of fn(*args) per call, CUDA events around ``iters``
    calls cycling through ``args_list`` (copies that overflow the L2 cache,
    so every call reads its operands from device memory, as serving does).
    A sleep kernel of ``sleep`` SM cycles per call, queued first, keeps the
    card busy while the host enqueues the calls, so a kernel shorter than
    its wrapper's host work is timed at the card's speed, not at the host's
    enqueue rate (a call that enqueues many kernels takes a longer sleep)."""
    import torch

    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep * iters)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_copies(torch, args: tuple, nbytes: float) -> list:
    """``args`` and copies of its tensors of 1 MiB or more, ceil(2 * L2 /
    nbytes) argument sets in all: cycling through them, each call of a
    function that reads ``nbytes`` finds its operands in device memory, as
    a serving step does after streaming ~7 GB of weights."""
    big = [torch.is_tensor(a) and a.numel() * a.element_size() >= 2**20 for a in args]
    return [args] + [tuple(a.clone() if b else a for a, b in zip(args, big))
                     for _ in range(max(1, math.ceil(2 * L2_BYTES / nbytes)) - 1)]


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / HBM_BPS, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def b1_case(torch, Q, DF, per_tensor_scale, gen, m, k, n, preset="precise", kw=None,
            plain_rows=None) -> dict:
    """B1 against its plain version at one (M, K, N) on a seeded weight
    (bit-equal, or it raises), timed cold with its plain version and its
    bound.  ``plain_rows`` runs the plain version over row blocks of that
    many rows (its float64 group dots take n_groups * M * N * 8 bytes, 110
    GB at llava-next-34b's prefill M): every output row depends on its own
    input row only, so the blocks give the whole call's bits."""
    kw = kw or {}
    cfg = Q.PRESETS[preset]
    icfg = dataclasses.replace(cfg.input_cfg, **kw)
    w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
    pw = Q.pack_weights(w, cfg)
    del w
    x = torch.randn(m, k, generator=gen, device="cuda")
    ts = per_tensor_scale(x, icfg.fmt).reshape(1)
    tw = pw.tscale.reshape(-1).contiguous()
    plain = DF.dsbp_fused_plain
    if plain_rows is not None:
        def plain(xx, *rest):
            return torch.cat([DF.dsbp_fused_plain(xx[i:i + plain_rows], *rest)
                              for i in range(0, xx.shape[0], plain_rows)])
    y = DF.dsbp_fused(x, ts, pw.ka, pw.kscale, tw, icfg)
    ref = plain(x, ts, pw.ka, pw.kscale, tw, icfg)
    torch.cuda.synchronize()
    if not torch.equal(y, ref):
        raise AssertionError(f"B1 kernel != plain at M={m} K={k} N={n} {kw}: max "
                             f"|diff| {float((y - ref).abs().max())}")
    err = float((y - ref).abs().max())
    del ref
    wbytes = pw.ka.numel() + pw.kscale.numel() * 4
    copies = [(x, ts, pw.ka.clone(), pw.kscale.clone(), tw, icfg)
              for _ in range(max(1, math.ceil(2 * L2_BYTES / wbytes)))]
    ms = cuda_ms(DF.dsbp_fused, copies, iters=30 if m <= 4 else 10)
    plain_ms = (cuda_ms(plain, copies[:1], iters=3, warmup=1) if plain_rows is None
                else cuda_ms(plain, copies[:1], iters=1, warmup=0, sleep=0))
    nbytes = m * pw.padded_k * 4 + wbytes + n * 4 + 4 + m * n * 4
    b_ms, b_by = bound(nbytes, 2.0 * m * pw.padded_k * n, FP16_OPS)
    row = {"M": m, "K": k, "N": n, "cfg": kw or "precise e4m3", "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "groups": pw.padded_k // 64, "max_abs_err": err}
    print(f"  B1 M={m:4d} K={k:5d} N={n:5d} {str(row['cfg']):40s} bit-equal; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    return row


def phase_b1(torch, Q, DF, per_tensor_scale):
    print("== phase 2: B1 dsbp_fused vs plain on the card")
    cases = [(m, k, n, "precise", {}) for m in (4, 512) for k, n in LLAMA_SHAPES]
    cases += [(512, 4096, 4096, "precise", {"fmt": "e5m2"}),
              (512, 4096, 4096, "precise", {"mode": "fixed", "k": 0.0, "b_fix": 7}),
              (512, 4096, 4096, "precise", {"mantissa_rounding": "trunc"})]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = [b1_case(torch, Q, DF, per_tensor_scale, gen, *case) for case in cases]
    torch.cuda.empty_cache()
    return rows, max(r["max_abs_err"] for r in rows)


def _sdpa(q, k, v, mask):
    import torch.nn.functional as F

    # one library call for GQA too (K/V heads shared by Hq/Hkv query heads)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=q.shape[1] != k.shape[1])


# (name, Hq, Hkv, D) of phase 3's attention shapes at full width: the main
# path's llama-7b, gemma3-12b (src/repro/configs/gemma3_12b.py), whose
# d_head 256 takes the kernels' second head-dim class, gemma3-12b's heads
# at d_head 320 and 512, which no config has (the one-warp-per-row kernel
# above 256), and mixtral-8x7b's GQA at D 128 (phase 20's B2)
B2_MODELS = (("llama-7b", 32, 32, 128), ("gemma3-12b", 16, 8, 256), ("d320", 16, 8, 320),
             ("d512", 16, 8, 512), ("mixtral-8x7b", 32, 8, 128))


def phase_b2(torch, FA):
    print("== phase 3: B2 flash_attention vs plain on the card (timed cold)")
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for model, hq, hkv, d in B2_MODELS:
        b, s = 4, 512
        q = torch.randn(b, hq, s, d, generator=gen, device="cuda")
        k = torch.randn(b, hkv, s, d, generator=gen, device="cuda")
        v = torch.randn(b, hkv, s, d, generator=gen, device="cuda")
        for name, qq, kv_len, q0 in (
                ("prefill", q, [512, 300, 129, 77], [0, 0, 0, 0]),
                ("decode", q[:, :, :1].contiguous(), [512, 301, 129, 18], [511, 300, 128, 17])):
            key = name if model == "llama-7b" else f"{name}-{model}"
            out[key] = b2_case(torch, FA, f"{model:10s} {name:7s}", qq, k, v, kv_len, q0)
        del q, k, v
    torch.cuda.empty_cache()
    return out


def b2_case(torch, FA, label: str, q, k, v, kv_len, q0, window: int = 0) -> dict:
    """B2 against its plain version (1e-5) at one shape (causal, under
    ``window``), with a head slice and a row slice bit-equal to the whole
    call, timed cold beside its plain version, torch's SDPA and its bound."""
    b, hq, sq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    kv_len = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    q0 = torch.tensor(q0, dtype=torch.int32, device="cuda")
    fa, plain = (functools.partial(f, window=window)
                 for f in (FA.flash_attention, FA.flash_attention_plain))
    o = fa(q, k, v, kv_len, q0)
    ref = plain(q, k, v, kv_len, q0)
    # a row's bits depend on its own keys only: half the KV heads (with
    # their query heads) and the last batch rows give the matching slices
    kh, qh, r0 = max(hkv // 2, 1), hq // 2, b // 2  # MQA: half the query heads
    heads = fa(q[:, :qh], k[:, :kh], v[:, :kh], kv_len, q0)
    rows = fa(q[r0:], k[r0:], v[r0:], kv_len[r0:], q0[r0:])
    torch.cuda.synchronize()
    err = float((o - ref).abs().max())
    close = torch.allclose(o, ref, rtol=1e-5, atol=1e-5)
    del ref
    # online-softmax order: per-tile rescaling rounds differently
    if not close:
        raise AssertionError(f"B2 {label.strip()}: kernel vs plain max |diff| {err}")
    if not (torch.equal(heads, o[:, :qh]) and torch.equal(rows, o[r0:])):
        raise AssertionError(f"B2 {label.strip()}: a head or row slice differs from the "
                             f"whole call")
    mask = FA.attention_mask(kv_len, q0, sq, s, causal=True, window=window)
    visible = float(mask.sum())  # (b, query, key) pairs this run attends
    nbytes = 2 * q.numel() * 4 + 2 * float(kv_len.sum()) * hkv * d * 4 + 8 * b
    b_ms, b_by = bound(nbytes, visible * hq * 4 * d, F32_OPS)
    # cold: every call reads K/V from device memory, as on the main path
    args = cold_copies(torch, (q, k, v, kv_len, q0), nbytes)
    ms = cuda_ms(fa, args, iters=20)
    plain_ms = cuda_ms(plain, args[:1], iters=5)
    lib_ms = cuda_ms(_sdpa, [(a[0], a[1], a[2], mask[:, None]) for a in args], iters=20)
    del args
    print(f"  B2 {label} B={b} Hq={hq} Hkv={hkv} Sq={sq} S={s} D={d}: max |diff| {err:.3g}, "
          f"head and row slices bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}), sdpa {lib_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "max_abs_err": err}


def _prompts(vocab, lens, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int64)
    for j, n in enumerate(lens):
        toks[j, :n] = rng.integers(0, vocab, n)
    return toks, np.asarray(lens, np.int32)


def cross_models(torch, TM, Engine, ServeConfig, cfg, n_layers):
    """``cfg`` cut to ``n_layers``: seeded weights drawn on the CPU, packed
    on the card by an Engine, and a CPU copy of the packed model:
    (card model, CPU model)."""
    cfg2 = cfg.replace(n_layers=n_layers)
    gpu_model = TM.Model(cfg2, "cuda")
    gpu_model.load_state_dict(TM.init(cfg2, seed=0, device="cpu").state_dict())
    gpu = Engine(gpu_model, ServeConfig(max_len=64), device="cuda")  # packs on the card
    return gpu.model, copy.deepcopy(gpu.model).to("cpu")


def phase_cross_device(torch, TM, Engine, ServeConfig, cfg):
    print(f"== phase 4: {CROSS_LAYERS}-layer full-width model, CPU (plain) vs card (kernels)")
    import numpy as np

    models = cross_models(torch, TM, Engine, ServeConfig, cfg, CROSS_LAYERS)
    scfg = ServeConfig(max_len=64)
    gpu = Engine(models[0], scfg, device="cuda")
    cpu = Engine(models[1], scfg, device="cpu")
    toks, lens = _prompts(cfg.vocab_size, [5, 17, 9, 12], seed=3)
    logits = {}
    for name, eng in (("cpu", cpu), ("gpu", gpu)):
        with torch.inference_mode():
            lg, _, _ = eng.model.prefill(torch.as_tensor(toks, device=eng.device),
                                         scfg.max_len, lengths=lens, quant=eng.quant)
        logits[name] = lg.float().cpu()
    diff = float((logits["cpu"] - logits["gpu"]).abs().max())
    scale = float(logits["cpu"].abs().max())
    if not (torch.isfinite(logits["gpu"]).all() and diff <= TIE * scale):
        raise AssertionError(f"CPU vs card prefill logits: max |diff| {diff} > "
                             f"{TIE} * {scale}")
    n_new = 8
    t_cpu = cpu.generate(toks, n_new, lengths=lens)
    t_gpu = gpu.generate(toks, n_new, lengths=lens)
    for r in range(len(lens)):
        bad = np.flatnonzero(t_cpu[r] != t_gpu[r])
        if bad.size:  # allowed only where the reference itself is a near tie
            t = int(bad[0])
            seq = np.concatenate([toks[r, :lens[r]], t_cpu[r, :t]])[None]
            with torch.inference_mode():
                lg = cpu.model.forward(torch.as_tensor(seq), quant=cpu.quant)[0, -1]
            top2 = torch.topk(lg, 2).values
            gap = float(top2[0] - top2[1])
            if gap >= TIE * float(lg.abs().max()):
                raise AssertionError(f"row {r} tokens diverge at step {t}: "
                                     f"{t_cpu[r]} vs {t_gpu[r]} (top-2 gap {gap})")
            print(f"  row {r}: near tie at step {t} (top-2 gap {gap:.3g}), "
                  f"compared up to it")
    print(f"  prefill logits max |diff| {diff:.3g} (max |logit| {scale:.3g}, "
          f"tolerance {TIE} relative); greedy tokens equal: {t_gpu.tolist()}")
    return models  # packed once; phases 9, 16a serve them again


def _serve_traffic(Request, vocab):
    """Phase 5's traffic (phase 15's too): 4 ragged prompts for generate,
    8 requests of 16 new tokens for serve."""
    import numpy as np

    toks, lens = _prompts(vocab, [16, 48, 96, 128], seed=4)
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, tokens=rng.integers(0, vocab, int(n)),
                    max_new_tokens=16) for i, n in enumerate(rng.integers(16, 129, 8))]
    return toks, lens, reqs


class SampleTape:
    """Keeps every batch an engine samples: its logit rows and the tokens
    drawn from them, in call order (device copies while the run lasts,
    moved to the host by :meth:`close`, so the run is not synchronised)."""

    def __init__(self, eng, vocab: int):
        self._eng, self._calls = eng, []
        sample = eng._sample

        def take(logits, gen, **kw):
            tok = sample(logits, gen, **kw)
            self._calls.append((logits[:, :vocab].float().clone(), tok.clone()))
            return tok
        eng._sample = take

    def close(self) -> list:
        del self._eng._sample
        return [(lg.cpu(), tok.cpu()) for lg, tok in self._calls]


def tie_bound(top: float, tie_ulps=None) -> float:
    """The near-tie bound at max|logit| ``top``: TIE * top for f32 logits,
    or ``tie_ulps`` bf16 ulps of top (8 significand bits) for bf16 ones,
    where ties and one-ulp near ties are common."""
    if tie_ulps is None:
        return TIE * top
    return tie_ulps * 2.0 ** (math.floor(math.log2(top)) - 7)


def check_calls(torch, ref, got, tie_ulps=None, kv_tie=KV_TIE):
    """Phase 9's rule over two runs' recorded sampled batches (same
    traffic, so the same calls in the same order): the tokens are equal up
    to the first batch where any differ; until then every logit row
    differs by at most ``kv_tie`` (default KV_TIE) * max|logit|, and in that batch each
    differing row's reference top-2 gap is below max(the near-tie bound
    (:func:`tie_bound`), twice the row's difference).  Returns (index of
    that batch or None, batches with bit-equal logits before it, largest
    difference relative to max|logit|)."""
    if len(ref) != len(got):
        raise AssertionError(f"{len(got)} sampled batches vs {len(ref)}")
    worst, equal = 0.0, 0
    for i, ((a, ta), (b, tb)) in enumerate(zip(ref, got)):
        if a.shape != b.shape:
            raise AssertionError(f"batch {i}: logits {tuple(b.shape)} vs {tuple(a.shape)}")
        top = float(a.abs().max())
        delta = (a - b).abs().amax(dim=1)
        worst = max(worst, float(delta.max()) / top)
        equal += bool(torch.equal(a, b))
        if float(delta.max()) > kv_tie * top:
            raise AssertionError(f"batch {i}: logits differ by {float(delta.max())} > "
                                 f"{kv_tie} * {top}")
        bad = torch.nonzero(ta != tb).flatten().tolist()
        for r in bad:
            top2 = torch.topk(a[r], 2).values
            gap = float(top2[0] - top2[1])
            limit = max(tie_bound(top, tie_ulps), 2 * float(delta[r]))
            if gap >= limit:
                raise AssertionError(f"batch {i} row {r}: tokens {int(ta[r])} vs "
                                     f"{int(tb[r])} (top-2 gap {gap}, limit {limit})")
        if bad:
            print(f"  batch {i}: rows {bad} diverge at near ties; later batches not compared")
            return i, equal, worst
    return None, equal, worst


# kernel names (torch.profiler) of each traced kernel's launches: phase 5
# (float KV, dsbp_fused) and phase 10 (kv8, dsbp_kernel: its decode steps
# attend through B5's instantiation of the attention kernels)
TRACE_FUSED = {"B1": ("::prep_kernel(", "::gemm_kernel<"),
               "B2": ("::split_kernel<", "::merge_kernel<", "::tile_kernel<")}
TRACE_TWO_KERNEL = {"B3": ("::fp8_quant_align_kernel(",),
                    "B4": ("::layout_kernel(", "::gemm_kernel<"),
                    "B5": ("::split_kernel<", "::merge_kernel<", "::tile_kernel<")}


def device_events(prof):
    """The profile's device events (kernels, copies), by name, with device
    time.  An ATen op on the host carries the time of the kernels it
    launched as its own ``self_device_time_total`` as well, so summing every
    entry of ``key_averages()`` counts each kernel PyTorch launches twice
    (the ctypes-launched kernels, which have no ATen op, once)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]


def greedy_next(eng, lg):
    """The greedy next step's tokens from logits (B, T, V): (B, 1), or (B,
    1, K) codebook frames for an audio model, chosen on the device."""
    from repro_torch.serve.engine import sample_tokens

    cfg = eng.cfg
    k = cfg.n_codebooks if cfg.frontend == "audio_codebooks" else 0
    return sample_tokens(lg[:, -1], n_codebooks=k)[:, None]


def trace_decode(torch, eng, toks, lens, kinds: dict, steps: int = 4,
                 max_len: int = 512, start=None) -> dict:
    """Device time by kernel (``kinds``: name -> kernel-name patterns) over
    ``steps`` decode steps of the engine's model (greedy tokens chosen on
    the card, as the engine's loop does without a host sync), in one
    torch.profiler window after a warm step, outside every timed pass;
    busy = the kernels' summed device time, idle share = 1 - busy / the
    window's host wall time.  ``start`` (tokens, cache, positions) of a
    run that has decoded already skips the prefill and the warm step.
    The profiler records device activity only, as phase 18's window does:
    no number here reads the host's ATen ops, which CPU activity would add
    to the window, and their post-processing took most of a trace's time
    at full depth."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        if start is None:
            lg, cache, _ = eng.model.prefill(torch.as_tensor(toks, device="cuda"), max_len,
                                             lengths=lens, quant=eng.quant, kv=eng.kv_spec)
            pos = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
            lg, cache = eng.model.decode_step(greedy_next(eng, lg), cache, pos, eng.quant)
            tok, pos = greedy_next(eng, lg), pos + 1
        else:
            tok, cache, pos = start
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                lg, cache = eng.model.decode_step(tok, cache, pos + i, eng.quant)
                tok = greedy_next(eng, lg)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    by = {k: [0.0, 0] for k in (*kinds, "other")}
    other = []
    for e in device_events(prof):
        us = e.self_device_time_total
        kind = next((k for k, pats in kinds.items() if any(p in e.key for p in pats)), "other")
        by[kind][0] += us / 1e3
        by[kind][1] += e.count
        if kind == "other":
            other.append((us / 1e3, e.key[:60]))
    busy = sum(v[0] for v in by.values())
    out = {"steps": steps, "wall_ms": wall_ms, "busy_ms": busy,
           "idle_share": 1 - busy / wall_ms if busy else None,
           **{f"{k}_ms": v[0] for k, v in by.items()},
           **{f"{k}_launches": v[1] for k, v in by.items()},
           "other_top": sorted(other, reverse=True)[:4]}
    if not busy:
        print(f"  trace, {steps} decode steps: torch.profiler recorded no device time on "
              f"this machine ({wall_ms:.2f} ms window)")
        return out
    per = ", ".join(f"{k} {v[0] / steps:.3f} ms ({v[1] // steps} kernels)"
                    for k, v in by.items() if k != "other")
    print(f"  trace, {steps} decode steps (torch.profiler, outside the timed pass): window "
          f"{wall_ms:.2f} ms, device busy {busy:.2f} ms, idle share "
          f"{out['idle_share']:.3f}; per step {per}, everything else "
          f"{by['other'][0] / steps:.3f} ms ({by['other'][1] // steps} kernels; largest "
          f"{[(n, round(t / steps, 4)) for t, n in out['other_top']]})")
    return out


def phase_serve(torch, TM, Engine, ServeConfig, Request, DF, FA, cfg):
    print("== phase 5: full-width llama-7b-paper, packed 'precise', generate + serve")
    import numpy as np

    t0 = time.perf_counter()
    model = TM.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = Engine(model, ServeConfig(max_len=512, batch_size=4), device="cuda")
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    rep = eng.pack_report
    print(f"  init {t_init:.2f} s, pack {t_pack:.2f} s: {rep['layers_packed']} projections, "
          f"{rep['raw_nbytes'] / 1e9:.3f} -> {rep['packed_nbytes'] / 1e9:.3f} GB, "
          f"avg W bits {rep['avg_w_bits']:.3f}, preset {rep['preset']}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    toks, lens, reqs = _serve_traffic(Request, cfg.vocab_size)

    # ---- the main path: counts from 0 over exactly this run, its sampled
    # batches recorded (phases 15 and 17 hold theirs bit-equal to them;
    # phase 18a serves the same traffic again, token for token) ----
    DF.dsbp_fused.launches = 0
    FA.flash_attention.launches = 0
    tape = SampleTape(eng, cfg.vocab_size)
    out = eng.generate(toks, 16, lengths=lens)
    gst = dict(eng.last_stats)
    served = eng.serve(reqs, max_new_tokens=16)
    torch.cuda.synchronize()
    calls = tape.close()
    launches = {"dsbp_fused": DF.dsbp_fused.launches,
                "flash_attention": FA.flash_attention.launches}
    sst = dict(eng.last_stats)
    peak = torch.cuda.max_memory_allocated()
    trace = trace_decode(torch, eng, toks, lens, TRACE_FUSED)

    if out.shape != (4, 16) or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"generate output {out.shape} out of range")
    if sorted(served) != list(range(8)) or any(len(t) != 16 for t in served.values()):
        raise AssertionError("serve did not return 16 tokens for each of 8 requests")
    with torch.inference_mode():
        lg, _, _ = eng.model.prefill(torch.as_tensor(toks, device="cuda"), 512,
                                     lengths=lens, quant=eng.quant)
    if lg.shape != (4, 1, cfg.padded_vocab_size) or not torch.isfinite(lg).all():
        raise AssertionError("full-width prefill logits are not finite")
    n_layers = cfg.n_layers
    print(f"  generate: 4 prompts (lens {lens.tolist()}), 16 new tokens: prefill "
          f"{gst['prefill_s']:.3f} s, decode {gst['decode_tokens'] / gst['decode_s']:.1f} "
          f"tok/s, {1e3 * gst['decode_s'] / gst['decode_steps']:.2f} ms/step")
    print(f"  serve: 8 requests (lens {[len(r.tokens) for r in reqs]}) through 4 slots: "
          f"{sst['decode_steps']} steps, {sst['admissions']} admissions, prefill "
          f"{sst['prefill_time_s']:.3f} s, decode {sst['decode_tps']:.1f} tok/s, "
          f"{1e3 * sst['decode_time_s'] / sst['decode_steps']:.2f} ms/step, occupancy "
          f"{sst['occupancy']:.3f}")
    print(f"  peak memory {peak / 2**30:.2f} GiB (max_memory_allocated)")
    print(f"  launches over generate + serve: {launches} (per decode step and per "
          f"prefill: dsbp_fused {7 * n_layers}, flash_attention {n_layers})")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    print(f"  KV bytes per token (float cache): {sst['kv_bytes_per_token']:.0f}")
    ref = {"generate": out, "serve": served, "calls": calls, "trace": trace,
           "decode_ms": 1e3 * sst["decode_time_s"] / sst["decode_steps"],
           "token_ms": 1e3 * sst["decode_time_s"] / sst["decode_tokens"], "peak": peak}
    return eng.model, launches, sst['kv_bytes_per_token'], ref


def launch_floor(torch, build) -> float:
    """Device time of a kernel that does nothing, timed as every kernel
    here (cuda_ms): the floor under a decode-sized launch."""
    empty = build.load("empty")

    def call():
        err = empty(torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")
    return cuda_ms(call, [()], iters=50)


def phase_b3(torch, Q, QA, per_tensor_scale, build):
    print("== phase 6: B3 fp8_quant_align vs plain on the card")
    cases = [(m, k, {}) for m in (4, 512) for k in (4096, 11008)]
    cases += [(512, 4096, {"fmt": "e5m2"}),
              (512, 4096, {"mode": "fixed", "k": 0.0, "b_fix": 7}),
              (512, 4096, {"mantissa_rounding": "trunc"})]
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for m, k, kw in cases:
        icfg = dataclasses.replace(Q.PRESETS["precise"].input_cfg, **kw)
        x = torch.randn(m, k, generator=gen, device="cuda")
        xs = x * per_tensor_scale(x, icfg.fmt)
        got = QA.fp8_quant_align(xs, icfg)
        ref = QA.fp8_quant_align_plain(xs, icfg)
        torch.cuda.synchronize()
        for name, g, r in zip(("a", "scale", "bits"), got, ref):
            if not torch.equal(g, r):
                raise AssertionError(f"B3 kernel != plain ({name}) at M={m} K={k} {kw}")
        nbytes = 8 * m * k + 8 * m * (k // 64)  # x in; a, scale, bits out
        ms = cuda_ms(QA.fp8_quant_align, cold_copies(torch, (xs, icfg), nbytes), iters=50)
        plain_ms = cuda_ms(QA.fp8_quant_align_plain, [(xs, icfg)], iters=5, warmup=1)
        b_ms, b_by = bound(nbytes, B3_OPS_PER_ELEM * m * k, F32_OPS)
        rows.append({"M": m, "K": k, "cfg": kw or "precise e4m3", "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
        print(f"  B3 M={m:4d} K={k:5d} {str(kw or 'precise e4m3'):40s} bit-equal; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{b_ms / ms:.0%} of it")
    floor = launch_floor(torch, build)
    print(f"  launch floor: an empty kernel takes {floor:.4f} ms (the same timing)")
    return rows, floor


def phase_b4(torch, Q, DM, TO):
    print("== phase 7: B4 dsbp_matmul vs plain, folded == unfolded, and B3+B4 vs B1, "
          "on the card")
    cfg = Q.PRESETS["precise"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows, max_err = [], 0.0
    for m in (4, 512):
        for k, n in LLAMA_SHAPES:
            w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
            pw = Q.pack_weights(w, cfg)
            del w
            x = torch.randn(m, k, generator=gen, device="cuda")
            qx = TO.fp8_quant_align(x, cfg.input_cfg)
            ax, sx = qx["a"], qx["scale"]
            ng = k // 64
            wbytes = pw.ka.numel() + pw.kscale.numel() * 4
            nbytes = m * k * 4 + m * ng * 4 + wbytes + m * n * 4
            copies = cold_copies(torch, (ax, sx, pw.ka, pw.kscale), nbytes)
            row = {"M": m, "K": k, "N": n}
            ref = DM.dsbp_matmul_plain(ax, sx, pw.ka, pw.kscale)
            # one order for both forms (DM's docstring)
            for folded in (False, True):
                y = DM.dsbp_matmul(ax, sx, pw.ka, pw.kscale, folded=folded)
                torch.cuda.synchronize()
                err = float((y - ref).abs().max())
                if not torch.equal(y, ref):
                    raise AssertionError(f"B4 folded={folded} M={m} K={k} N={n} "
                                         f"!= plain: {err}")
                max_err = max(max_err, err)
            if not torch.equal(DM.dsbp_matmul_plain(ax, sx, pw.ka, pw.kscale, folded=False),
                               ref):
                raise AssertionError(f"B4 plain folded != unfolded at M={m} K={k} N={n}")
            row["ms"] = cuda_ms(DM.dsbp_matmul, copies, iters=30 if m <= 4 else 10)
            row["plain_ms"] = cuda_ms(DM.dsbp_matmul_plain, copies[:1], iters=3, warmup=1)
            two = TO.dsbp_matmul_packed(x, pw)
            one = TO.dsbp_matmul_fused(x, pw)
            torch.cuda.synchronize()
            d12, top = float((two - one).abs().max()), float(one.abs().max())
            if d12 > 3e-5 * top:
                raise AssertionError(f"B3+B4 vs B1 at M={m} K={k} N={n}: max |diff| {d12} "
                                     f"> 3e-5 * {top}")
            row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * m * k * n, FP16_OPS)
            row["b3b4_vs_b1"] = d12
            rows.append(row)
            print(f"  B4 M={m:4d} K={k:5d} N={n:5d}: bit-equal to plain, folded == unfolded; "
                  f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms; bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}); B3+B4 vs B1 |diff| "
                  f"{d12:.3g} (max |y| {top:.3g})")
            del pw, copies, two, one, qx, ax, sx, x, ref
    torch.cuda.empty_cache()
    return rows, max_err


def phase_b5(torch, FA, KVQ):
    print("== phase 8: B5 packed_flash_attention vs B2 over dequantize() and plain "
          "(timed cold)")
    gen = torch.Generator(device="cuda").manual_seed(8)
    kv8 = KVQ.KV_PRESETS["kv8"]
    out = {}
    # llama-7b's decode and a 128-query chunk; gemma3-12b's decode (d_head
    # 256, GQA 16 / 8) and its heads at d_head 320 and 512
    for model, hq, hkv, d, cases in (
            ("llama-7b", 32, 32, 128,
             (("decode", 1, [2048, 1501, 700, 37], [2047, 1500, 699, 36]),
              ("chunk", 128, [2048, 1128, 328, 192], [1920, 1000, 200, 64]))),
            ("gemma3-12b", 16, 8, 256,
             (("decode-gemma3-12b", 1, [2048, 1501, 700, 37], [2047, 1500, 699, 36]),)),
            ("d320", 16, 8, 320,
             (("decode-d320", 1, [2048, 1501, 700, 37], [2047, 1500, 699, 36]),)),
            ("d512", 16, 8, 512,
             (("decode-d512", 1, [2048, 1501, 700, 37], [2047, 1500, 699, 36]),))):
        b, s = 4, 2048
        k = KVQ.quantize_kv(torch.randn(b, hkv, s, d, generator=gen, device="cuda"), kv8)
        v = KVQ.quantize_kv(torch.randn(b, hkv, s, d, generator=gen, device="cuda"), kv8)
        for name, sq, kv_len, q0 in cases:
            q = torch.randn(b, hq, sq, d, generator=gen, device="cuda")
            out[name] = b5_case(torch, FA, f"{name:17s}", q, k, v, kv_len, q0)
        del k, v
    torch.cuda.empty_cache()
    return out


def b5_case(torch, FA, label: str, q, k, v, kv_len, q0) -> dict:
    """B5 over the packed K/V caches ``k`` / ``v`` (``quantize_kv``) at one
    shape: bit-equal to B2 over ``dequantize()`` and within 1e-5 of its
    plain version, timed cold beside B2, its plain version and SDPA over
    the dequantized caches (a yardstick: no library call reads int8 K/V),
    with its bound."""
    b, hq, sq, d = q.shape
    hkv, s = k.qm.shape[1], k.qm.shape[2]
    kd, vd = k.dequantize(), v.dequantize()
    kv_len = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    q0 = torch.tensor(q0, dtype=torch.int32, device="cuda")
    args = (q, k.qm, k.scale, v.qm, v.scale, kv_len, q0)
    o = FA.packed_flash_attention(*args)
    b2 = FA.flash_attention(q, kd, vd, kv_len, q0)
    ref = FA.packed_flash_attention_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(o, b2):
        raise AssertionError(f"B5 {label.strip()} != B2 over dequantize(): max |diff| "
                             f"{float((o - b2).abs().max())}")
    err = float((o - ref).abs().max())
    if not torch.allclose(o, ref, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"B5 {label.strip()}: kernel vs plain max |diff| {err}")
    del o, b2, ref
    mask = FA.attention_mask(kv_len, q0, sq, s, causal=True, window=0)
    visible = float(mask.sum())
    # each row reads its keys up to kv_len once: int8 K/V + f32 scales
    nbytes = 2 * q.numel() * 4 + 2 * float(kv_len.sum()) * hkv * (d + 4) + 8 * b
    b_ms, b_by = bound(nbytes, visible * hq * 4 * d, F32_OPS)
    # cold, as phase 3: copies of the packed and the dequantized caches
    cold = cold_copies(torch, (*args, kd, vd), nbytes)
    ms = cuda_ms(FA.packed_flash_attention, [c[:7] for c in cold], iters=20)
    plain_ms = cuda_ms(FA.packed_flash_attention_plain, [args], iters=5)
    b2_ms = cuda_ms(FA.flash_attention, [(c[0], c[7], c[8], kv_len, q0) for c in cold],
                    iters=20)
    sdpa_ms = cuda_ms(_sdpa, [(c[0], c[7], c[8], mask[:, None]) for c in cold], iters=20)
    del cold
    print(f"  B5 {label} B={b} Hq={hq} Hkv={hkv} Sq={sq} S={s} D={d} (keys "
          f"{kv_len.tolist()}): bit-equal to B2 over dequantize(), |diff| to plain {err:.3g}; "
          f"kernel {ms:.4f} ms, B2 {b2_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} "
          f"ms ({b_by}), sdpa over dequantized K/V {sdpa_ms:.4f} ms (yardstick)")
    return {"ms": ms, "plain_ms": plain_ms, "b2_ms": b2_ms, "sdpa_dequantized_ms": sdpa_ms,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}


def phase_kv_cross_device(torch, Engine, ServeConfig, Request, blocks, KVQ, models, cfg):
    print(f"== phase 9: {CROSS_LAYERS}-layer full width, kv8 + dsbp_kernel: CPU (plain) vs card "
          "(kernels); packed KV vs quantize-dequantize oracle on the card")
    import numpy as np

    gpu_model, cpu_model = models
    scfg = ServeConfig(max_len=64, kv_quant="kv8", quant_method="dsbp_kernel")
    gpu = Engine(gpu_model, scfg, device="cuda")
    cpu = Engine(cpu_model, scfg, device="cpu")
    toks, lens = _prompts(cfg.vocab_size, [5, 17, 9, 12], seed=3)
    n_new = 8
    t_cpu = cpu.generate(toks, n_new, lengths=lens)
    t_gpu = gpu.generate(toks, n_new, lengths=lens)

    # the CPU's tokens teacher-forced through both devices: per step logits
    # and, after the run, the packed caches
    def forced(eng):
        with torch.inference_mode():
            lg, cache, _ = eng.model.prefill(torch.as_tensor(toks, device=eng.device),
                                             scfg.max_len, lengths=lens, quant=eng.quant,
                                             kv=eng.kv_spec)
            steps = [lg[:, -1].float().cpu()]
            pos = torch.as_tensor(lens, device=eng.device)
            for t in range(n_new - 1):
                lg, cache = eng.model.decode_step(
                    torch.as_tensor(t_cpu[:, t:t + 1], device=eng.device), cache, pos + t,
                    eng.quant)
                steps.append(lg[:, -1].float().cpu())
        return torch.stack(steps, dim=1), cache

    l_cpu, c_cpu = forced(cpu)
    l_gpu, c_gpu = forced(gpu)
    delta = (l_cpu - l_gpu).abs().amax(dim=-1)  # (B, n_new) max |logit diff|
    top = float(l_cpu.abs().max())
    flips = sum(int((a[n].qm != b[n].qm.cpu()).sum()) for a, b in zip(c_cpu, c_gpu)
                for n in ("k", "v"))
    flip_max = max(int((a[n].qm.int() - b[n].qm.cpu().int()).abs().max())
                   for a, b in zip(c_cpu, c_gpu) for n in ("k", "v"))
    total = sum(a[n].qm.numel() for a in c_cpu for n in ("k", "v"))
    print(f"  teacher-forced max |logit diff| CPU vs card per step: "
          f"{[round(float(x), 6) for x in delta.amax(dim=0)]} (max |logit| {top:.3g}); "
          f"KV mantissas differing: {flips} of {total}, by at most {flip_max}")
    if float(delta[:, 0].max()) > TIE * top:  # prefill, as phase 4
        raise AssertionError(f"kv8+dsbp_kernel prefill logits differ by "
                             f"{float(delta[:, 0].max())} > {TIE} * {top}")
    if float(delta.max()) > KV_TIE * top:
        raise AssertionError(f"kv8+dsbp_kernel decode logits differ by {float(delta.max())} "
                             f"> {KV_TIE} * {top}")
    for r in range(len(lens)):
        bad = np.flatnonzero(t_cpu[r] != t_gpu[r])
        if bad.size:  # allowed only where the two devices' logits disagree on the order
            t = int(bad[0])
            top2 = torch.topk(l_cpu[r, t], 2).values
            gap = float(top2[0] - top2[1])
            if gap >= max(TIE * top, 2 * float(delta[r, t])):
                raise AssertionError(f"kv8+dsbp_kernel row {r} tokens diverge at step {t}: "
                                     f"{t_cpu[r]} vs {t_gpu[r]} (top-2 gap {gap}, logit "
                                     f"diff {float(delta[r, t])})")
            print(f"  row {r}: near tie at step {t} (top-2 gap {gap:.3g} < twice the "
                  f"CPU-vs-card logit diff {float(delta[r, t]):.3g}), compared up to it")
    print(f"  CPU vs card greedy tokens: {t_gpu.tolist()}")

    rng = np.random.default_rng(9)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, n), max_new_tokens=8)
            for i, n in enumerate([5, 17, 9, 12, 7, 20])]
    packed = gpu.serve(reqs)
    real = blocks.quantize_like

    def qdq(leaf, fresh):  # a float cache whose every write is quantized first
        if not isinstance(leaf, KVQ.PackedKVBlock):
            return KVQ.quantize_kv(fresh, KVQ.KV_PRESETS["kv8"]).dequantize()
        return real(leaf, fresh)

    blocks.quantize_like = qdq
    try:
        oracle = Engine(gpu_model, ServeConfig(max_len=64, quant_method="dsbp_kernel"),
                        device="cuda").serve(reqs)
    finally:
        blocks.quantize_like = real
    for uid in packed:
        if not np.array_equal(packed[uid], oracle[uid]):
            raise AssertionError(f"request {uid}: packed-KV serving {packed[uid]} != "
                                 f"quantize-dequantize oracle {oracle[uid]}")
    print(f"  packed-KV serve == qdq-oracle serve for {len(reqs)} requests through 4 slots")
    del gpu, cpu, gpu_model, cpu_model
    torch.cuda.empty_cache()


def _reset_launches(kernels):
    for fn in kernels.values():
        fn.launches = 0
        if hasattr(fn, "bf16_launches"):  # the attention kernels' bf16 instantiation
            fn.bf16_launches = 0


def phase_kv_serve(torch, Engine, ServeConfig, Request, TO, kernels, model, cfg,
                   float_bpt):
    print("== phase 10: full-width llama-7b-paper, kv8 + dsbp_kernel generate + serve, "
          "then kv8 + dsbp_fused serve")
    import numpy as np

    toks, lens, reqs = _serve_traffic(Request, cfg.vocab_size)
    n_layers = cfg.n_layers
    eng = Engine(model, ServeConfig(max_len=512, batch_size=4, kv_quant="kv8",
                                    quant_method="dsbp_kernel"), device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- this slice's main path: counts from 0 over exactly this run ----
    _reset_launches(kernels)
    out = eng.generate(toks, 16, lengths=lens)
    gst = dict(eng.last_stats)
    served = eng.serve(reqs, max_new_tokens=16)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    sst = dict(eng.last_stats)
    peak = torch.cuda.max_memory_allocated()

    if out.shape != (4, 16) or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"kv8 generate output {out.shape} out of range")
    if sorted(served) != list(range(8)) or any(len(t) != 16 for t in served.values()):
        raise AssertionError("kv8 serve did not return 16 tokens for each of 8 requests")
    steps = gst["decode_steps"] + sst["decode_steps"]
    prefills = launches["flash_attention"] // n_layers
    if launches["dsbp_fused"] or launches["flash_attention"] % n_layers or not prefills \
            or launches["packed_flash_attention"] != n_layers * steps \
            or not (launches["fp8_quant_align"] == launches["dsbp_matmul"]
                    == 7 * n_layers * (prefills + steps)):
        raise AssertionError(f"kv8 + dsbp_kernel launches {launches} do not match "
                             f"{steps} decode steps and {n_layers} layers")
    bpt = sst["kv_bytes_per_token"]
    if not sst["kv_packed"] or bpt != 2 * n_layers * cfg.n_kv_heads * (cfg.d_head + 4):
        raise AssertionError(f"kv8 bytes per token {bpt}")
    print(f"  generate: prefill {gst['prefill_s']:.3f} s, decode "
          f"{gst['decode_tokens'] / gst['decode_s']:.1f} tok/s, "
          f"{1e3 * gst['decode_s'] / gst['decode_steps']:.2f} ms/step")
    print(f"  serve: {sst['decode_steps']} steps, {sst['admissions']} admissions, prefill "
          f"{sst['prefill_time_s']:.3f} s, decode {sst['decode_tps']:.1f} tok/s, "
          f"{1e3 * sst['decode_time_s'] / sst['decode_steps']:.2f} ms/step, occupancy "
          f"{sst['occupancy']:.3f}")
    print(f"  peak memory {peak / 2**30:.2f} GiB; KV bytes per token {bpt:.0f} packed vs "
          f"{float_bpt:.0f} float ({float_bpt / bpt:.2f}x less)")
    print(f"  launches over generate + serve: {launches} ({steps} decode steps, {prefills} "
          f"prefills; per decode step and per prefill: B3 = B4 = {7 * n_layers}, "
          f"B5 = {n_layers} per step, B2 = {n_layers} per prefill)")

    # ---- the dispatch contracts over one full-width decode step ----
    with torch.inference_mode():
        lg, cache, _ = eng.model.prefill(torch.as_tensor(toks, device="cuda"), 512,
                                         lengths=lens, quant=eng.quant, kv=eng.kv_spec)
        step = torch.argmax(lg[:, -1], dim=-1)[:, None]
        pos = torch.as_tensor(lens, device="cuda")

        def decode():
            return eng.model.decode_step(step, cache, pos, eng.quant)

        relayouts = TO.count_weight_transposes(decode, min_size=4096 * 4096)
        dequants = TO.count_kv_dequants(decode, min_size=cache[0]["k"].qm.numel())
    if relayouts or dequants:
        raise AssertionError(f"a packed decode step dispatched {relayouts} weight-sized "
                             f"relayouts and {dequants} KV-sized dequantizes")
    print("  one decode step dispatches 0 weight-sized relayouts and 0 KV-sized "
          "int8->float conversions outside the kernels")
    del cache, lg
    trace = trace_decode(torch, eng, toks, lens, TRACE_TWO_KERNEL)

    fused = Engine(model, ServeConfig(max_len=512, batch_size=4, kv_quant="kv8"),
                   device="cuda")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(kernels)
    served = fused.serve(reqs, max_new_tokens=16)
    torch.cuda.synchronize()
    fl = {name: fn.launches for name, fn in kernels.items()}
    fst = dict(fused.last_stats)
    fpeak = torch.cuda.max_memory_allocated()
    if sorted(served) != list(range(8)) or any(len(t) != 16 for t in served.values()):
        raise AssertionError("kv8 + dsbp_fused serve did not return 16 tokens each")
    if fl["dsbp_fused"] <= 0 or fl["flash_attention"] <= 0 or fl["packed_flash_attention"] \
            != n_layers * fst["decode_steps"] or fl["fp8_quant_align"] or fl["dsbp_matmul"]:
        raise AssertionError(f"kv8 + dsbp_fused launches {fl}")
    print(f"  kv8 + dsbp_fused serve: {fst['decode_steps']} steps, prefill "
          f"{fst['prefill_time_s']:.3f} s, decode {fst['decode_tps']:.1f} tok/s, "
          f"{1e3 * fst['decode_time_s'] / fst['decode_steps']:.2f} ms/step, peak "
          f"{fpeak / 2**30:.2f} GiB; launches {fl}")
    return launches, fl, trace


def _distinct_keys(table, kv_len, bs: int) -> int:
    """Key rows a paged read must load: key j < kv_len[b] of row b lives in
    pool slot (table[b, j // bs], j % bs), and a slot that several rows
    reach through shared blocks is loaded once."""
    import numpy as np

    tab, lens = table.cpu().numpy().astype(np.int64), kv_len.cpu().numpy()
    slots = [tab[b, np.arange(n) // bs] * bs + np.arange(n) % bs
             for b, n in enumerate(lens.tolist())]
    return int(np.unique(np.concatenate(slots)).size)


def _serve_table(torch, gen, rows, mb: int, nb: int):
    """A table like the ones phase 13 hands B6/B7: ``rows`` of (kv_len,
    blocks held, leading blocks shared with row 0); a row holding no
    block is all scratch (block 0), as idle lanes are."""
    perm = (torch.randperm(nb - 1, generator=gen, device="cuda") + 1).to(torch.int32)
    table = torch.zeros(len(rows), mb, dtype=torch.int32, device="cuda")
    used = 0
    for b, (_, held, shared) in enumerate(rows):
        table[b, :shared] = table[0, :shared]
        table[b, shared:held] = perm[used: used + held - shared]
        used += held - shared
    kv_len = torch.tensor([n for n, _, _ in rows], dtype=torch.int32, device="cuda")
    return table, kv_len


def _gather_sdpa_b6(FA, q, pk, pv, table, mask):
    return _sdpa(q, FA.gather_blocks(pk, table), FA.gather_blocks(pv, table), mask)


def _gather_sdpa_b7(FA, q, kqm, ksc, vqm, vsc, table, mask):
    k = FA.gather_blocks(kqm, table) * FA.gather_blocks(ksc, table)
    v = FA.gather_blocks(vqm, table) * FA.gather_blocks(vsc, table)
    return _sdpa(q, k, v, mask)


def phase_b6_b7(torch, FA, KVQ):
    print("== phase 11: B6 / B7 paged flash attention vs B2 / B5 over the gathered "
          "view and plain (timed cold)")
    gen = torch.Generator(device="cuda").manual_seed(11)
    h, d, bs = 32, 128, 16
    kv8 = KVQ.KV_PRESETS["kv8"]

    def pools(nb, hkv=h, dd=d):
        pk = torch.randn(nb, hkv, bs, dd, generator=gen, device="cuda")
        pv = torch.randn(nb, hkv, bs, dd, generator=gen, device="cuda")
        return pk, pv, KVQ.quantize_kv(pk, kv8), KVQ.quantize_kv(pv, kv8)

    # B=4 rows over 2,048 keys each: shuffled tables over blocks 1..512, one
    # where no block is shared and one where rows 1-3 share row 0's first
    # 20 blocks
    big = pools(4 * 128 + 1)
    perm = (torch.randperm(4 * 128, generator=gen, device="cuda") + 1).to(torch.int32)
    own = perm.reshape(4, 128).clone()
    shared = own.clone()
    shared[1:, :20] = shared[0, :20]
    ragged = torch.tensor([2048, 1501, 700, 37], dtype=torch.int32, device="cuda")
    # the main path's shape (phase 13): 8 lanes, max_len 512 (MB 32), 129
    # blocks; lanes 1 and 6 share lane 0's 12 system-prompt blocks, lanes 2
    # and 5 are idle (all scratch, kv_len 1), lane 3 is mid chunked prefill
    # (its own blocks, stale position 0)
    lanes = ((209, 14, 0), (215, 14, 12), (1, 0, 0), (1, 21, 0), (330, 21, 0),
             (1, 0, 0), (223, 14, 12), (512, 32, 0))
    serve_table, serve_len = _serve_table(torch, gen, lanes, 32, 129)
    # gemma3-12b's decode (d_head 256, GQA 16 / 8) over the shared table, and
    # its heads at d_head 320 and 512
    cases = (("serve", pools(129), serve_table, 1, serve_len, h, d),
             ("decode", big, shared, 1, ragged, h, d),
             ("decode-unshared", big, own, 1, ragged, h, d),
             ("chunk", big, shared, 16,
              torch.tensor([1000, 537, 250, 77], dtype=torch.int32, device="cuda"), h, d),
             ("decode-gemma3-12b", pools(4 * 128 + 1, 8, 256), shared, 1, ragged, 16, 256),
             ("decode-d320", pools(4 * 128 + 1, 8, 320), shared, 1, ragged, 16, 320),
             ("decode-d512", pools(4 * 128 + 1, 8, 512), shared, 1, ragged, 16, 512))
    out = {}
    for name, (pk, pv, kq, vq), table, sq, kv_len, hq, d in cases:
        b, mb = table.shape
        hkv = pk.shape[1]
        q = torch.randn(b, hq, sq, d, generator=gen, device="cuda")
        q0 = kv_len - sq
        gk, gv = FA.gather_blocks(pk, table), FA.gather_blocks(pv, table)
        gq = [FA.gather_blocks(t, table) for t in (kq.qm, kq.scale, vq.qm, vq.scale)]
        mask = FA.attention_mask(kv_len, q0, sq, mb * bs, causal=True, window=0)
        visible = float(mask.sum())
        keys = _distinct_keys(table, kv_len, bs)
        am = mask[:, None]
        for kname, fn, args, dense, dargs, plain, kvb in (
                ("B6", FA.paged_flash_attention, (q, pk, pv, table, kv_len, q0),
                 FA.flash_attention, (q, gk, gv, kv_len, q0),
                 FA.paged_flash_attention_plain, 4 * d),
                ("B7", FA.paged_packed_flash_attention,
                 (q, kq.qm, kq.scale, vq.qm, vq.scale, table, kv_len, q0),
                 FA.packed_flash_attention, (q, *gq, kv_len, q0),
                 FA.paged_packed_flash_attention_plain, d + 4)):
            o = fn(*args)
            ref = dense(*dargs)
            pl = plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(o, ref):
                raise AssertionError(f"{kname} {name} != its dense kernel over the gathered "
                                     f"view: max |diff| {float((o - ref).abs().max())}")
            err = float((o - pl).abs().max())
            if not torch.allclose(o, pl, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"{kname} {name}: kernel vs plain max |diff| {err}")
            # every distinct key row it needs once, the queries, the output,
            # its table rows and the lengths
            nbytes = (2 * q.numel() * 4 + 2 * keys * hkv * kvb + table.numel() * 4 + 8 * b)
            b_ms, b_by = bound(nbytes, visible * hq * 4 * d, F32_OPS)
            # cold, as phase 3: copies of the pools and of the gathered views
            np_ = len(args)
            cold = cold_copies(torch, (*args, *dargs[1:-2]), nbytes)
            ms = cuda_ms(fn, [c[:np_] for c in cold], iters=20)
            dense_ms = cuda_ms(dense, [(q, *c[np_:], kv_len, q0) for c in cold], iters=20)
            plain_ms = cuda_ms(plain, [args], iters=5)
            yard = _gather_sdpa_b6 if kname == "B6" else _gather_sdpa_b7
            yard_ms = cuda_ms(yard, [(FA, *c[:np_ - 2], am) for c in cold], iters=10)
            del cold
            out[(kname, name)] = {"ms": ms, "dense_ms": dense_ms, "plain_ms": plain_ms,
                                  "gather_sdpa_ms": yard_ms, "bound_ms": b_ms,
                                  "bound_by": b_by, "max_abs_err": err, "keys": keys}
            print(f"  {kname} {name:17s} B={b} Hq={hq} Hkv={hkv} D={d} Sq={sq} bs={bs} MB={mb} "
                  f"keys {int(kv_len.sum())} ({keys} distinct): bit-equal to "
                  f"{'B2' if kname == 'B6' else 'B5'} over the gathered view, |diff| to "
                  f"plain {err:.3g}; kernel {ms:.4f} ms, dense over gathered "
                  f"{dense_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}), gather + sdpa {yard_ms:.4f} ms (yardstick)")
    del big, cases
    torch.cuda.empty_cache()
    return out


def forced_logits(torch, eng, prompt, toks, kv):
    """(len(toks), Vp) logits of a stream teacher-forced through the dense
    path of ``eng`` at batch 1: row 0 from the prompt's prefill, row i from
    decoding toks[i - 1]."""
    with torch.inference_mode():
        dev = eng.device
        lg, cache, _ = eng.model.prefill(torch.as_tensor(prompt[None], device=dev),
                                         eng.scfg.max_len, quant=eng.quant, kv=kv)
        rows = [lg[0, -1].float().cpu()]
        for i, t in enumerate(toks[:-1]):
            lg, cache = eng.model.decode_step(torch.as_tensor([[int(t)]], device=dev), cache,
                                              len(prompt) + i, eng.quant)
            rows.append(lg[0, -1].float().cpu())
    return torch.stack(rows)


def check_streams(torch, ref, got, prompts, ref_eng, other_eng, kv=None):
    """Every stream of ``got`` equals ``ref``'s, except from a step where
    the reference's own top-2 logit gap (teacher-forced) is below TIE *
    max|logit| or twice the two devices' logit difference there (phase 9's
    rule).  Returns the near ties taken."""
    ties = []
    for uid, want in ref.items():
        have = got[uid]
        bad = [i for i in range(min(len(want), len(have))) if want[i] != have[i]]
        if not bad:
            if len(want) != len(have):
                raise AssertionError(f"request {uid}: {len(have)} tokens vs {len(want)}")
            continue
        t = bad[0]
        lg = forced_logits(torch, ref_eng, prompts[uid], want[:t + 1], kv)[t]
        top2 = torch.topk(lg, 2).values
        gap, top = float(top2[0] - top2[1]), float(lg.abs().max())
        lo = forced_logits(torch, other_eng, prompts[uid], want[:t + 1], kv)[t]
        delta = float((lg - lo).abs().max())
        if delta > KV_TIE * top:
            raise AssertionError(f"request {uid}: step {t} logits differ by {delta} "
                                 f"> {KV_TIE} * {top}")
        limit = max(TIE * top, 2 * delta)
        if gap >= limit:
            raise AssertionError(f"request {uid} diverges at step {t}: {want} vs {have} "
                                 f"(top-2 gap {gap}, limit {limit})")
        ties.append((uid, t, gap))
        print(f"  request {uid}: near tie at step {t} (top-2 gap {gap:.3g} < {limit:.3g}), "
              f"compared up to it")
    return ties


class GuardTape:
    """For every token a serve emits, the logit row it was drawn from:
    ``rows[uid]`` lists them in emission order.  It wraps the engine's one
    sampling site for served tokens (``Engine._apply_guard``: admissions,
    decode steps, chunk finishes; one call per sampled batch, one row per
    lane it names), with or without a guard: a row the guard rejects emits
    nothing, and a 'fallback' retry's call replaces its step's first.  Each
    call's batch crosses to the host in one copy (1 MB at full width, 4
    lanes), after the call's own sync."""

    def __init__(self, eng, vocab: int):
        self.rows: dict = {}
        self._eng, pending = eng, []
        apply = eng._apply_guard

        def take(last, occ, uid_of, ctl, **kw):
            toks, bad = apply(last, occ, uid_of, ctl, **kw)
            if not kw.get("retry"):
                self._commit(pending)
            host = last[:, :vocab].float().cpu()
            pending[:] = [(uid_of(i), host[i], int(toks[i])) for i in occ if i not in bad]
            return toks, bad

        self._pending = pending
        eng._apply_guard = take

    def _commit(self, pending) -> None:
        for uid, row, t in pending:
            if int(row.argmax()) != t:
                raise AssertionError(f"logit tape out of step at request {uid}")
            self.rows.setdefault(uid, []).append(row)
        pending.clear()

    def close(self) -> dict:
        self._commit(self._pending)
        del self._eng._apply_guard
        return self.rows


def check_recorded(torch, ref, got, ref_rows, got_rows, prefix=(), kv_tie=KV_TIE):
    """Phase 9's rule on logits the two serves computed: each stream of
    ``got`` equals ``ref``'s up to its first differing token t; at every
    step up to t (the same context in both) the two rows differ by at most
    ``kv_tie`` (default KV_TIE) * max|logit|, and at t the reference's
    top-2 gap is below max(TIE * max|logit|, twice the difference there).
    A stream of a uid
    in ``prefix`` (one that ended early: cancelled, expired, quarantined)
    is held so against the head of the reference.  Returns the near ties
    taken and each stream's largest difference relative to max|logit|."""
    import numpy as np

    ties, worst = [], {}
    for uid, want in ref.items():
        have = got[uid]
        if uid in prefix and len(have) <= len(want):
            want = want[:len(have)]
        if len(want) != len(have):
            raise AssertionError(f"request {uid}: {len(have)} tokens vs {len(want)}")
        if not len(have):
            continue
        bad = np.flatnonzero(want != have)
        t = int(bad[0]) if bad.size else len(want) - 1
        for step in range(t + 1):
            a, b = ref_rows[uid][step], got_rows[uid][step]
            top, delta = float(a.abs().max()), float((a - b).abs().max())
            worst[uid] = max(worst.get(uid, 0.0), delta / top)
            if delta > kv_tie * top:
                raise AssertionError(f"request {uid}: step {step} logits differ by {delta} "
                                     f"> {kv_tie} * {top}")
        if bad.size:
            top2 = torch.topk(ref_rows[uid][t], 2).values
            gap = float(top2[0] - top2[1])
            limit = max(TIE * top, 2 * delta)
            if gap >= limit:
                raise AssertionError(f"request {uid} diverges at step {t}: {want} vs {have} "
                                     f"(top-2 gap {gap}, limit {limit})")
            ties.append((uid, t, gap, delta))
            print(f"  request {uid}: near tie at step {t} (top-2 gap {gap:.3g} < twice the "
                  f"logit difference {delta:.3g}), compared up to it")
    return ties, worst


def _shared_requests(Request, vocab, n_shared, sys_len, tail, n_long, long_len, new, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(0, vocab, sys_len)
    toks = [rng.integers(0, vocab, long_len) for _ in range(n_long)]
    toks += [np.concatenate([sys_prompt, rng.integers(0, vocab, tail)])
             for _ in range(n_shared)]
    return [Request(uid=i, tokens=t, max_new_tokens=new) for i, t in enumerate(toks)]


def phase_paged_cross_device(torch, TM, Engine, ServeConfig, Request, FA, cfg):
    print(f"== phase 12: {PAGED_CROSS_LAYERS}-layer full width, paged serve (shared prefix + "
          "chunked prompt), CPU (plain) vs card (kernels), float pool and kv8 pool")
    gpu_model, cpu_model = cross_models(torch, TM, Engine, ServeConfig, cfg,
                                        PAGED_CROSS_LAYERS)
    reqs = _shared_requests(Request, cfg.vocab_size, n_shared=3, sys_len=32, tail=7,
                            n_long=1, long_len=48, new=6, seed=12)
    prompts = {r.uid: r.tokens for r in reqs}
    for kv in (None, "kv8"):
        scfg = ServeConfig(max_len=128, batch_size=2, max_active=4, paged=True,
                           kv_block_size=16, chunk_prefill_tokens=40, kv_quant=kv)
        cpu = Engine(cpu_model, scfg, device="cpu")
        gpu = Engine(gpu_model, scfg, device="cuda")
        t_cpu = cpu.serve(reqs)
        cst = dict(cpu.last_stats)
        b6, b7 = FA.paged_flash_attention.launches, FA.paged_packed_flash_attention.launches
        t_gpu = gpu.serve(reqs)
        gst = dict(gpu.last_stats)
        fired = (FA.paged_flash_attention.launches - b6,
                 FA.paged_packed_flash_attention.launches - b7)
        n = PAGED_CROSS_LAYERS * gst["decode_steps"]
        if fired != ((n, 0) if kv is None else (0, n)):
            raise AssertionError(f"paged {kv or 'float'}: B6/B7 launches {fired} for "
                                 f"{gst['decode_steps']} decode steps of {PAGED_CROSS_LAYERS} "
                                 "layers")
        if not (gst["prefix_hit_blocks"] > 0 and gst["chunked_requests"] == 1
                and gst["stalled_decode_steps"] == 0):
            raise AssertionError(f"paged {kv or 'float'} stats {gst}")
        # phase 9's rule for both pools: the chunked prompt's verify pass
        # runs PyTorch attention, whose sum order differs on the two devices
        check_streams(torch, t_cpu, t_gpu, prompts, cpu, gpu, kv=kv)
        print(f"  {kv or 'float'} pool: tokens CPU vs card equal (near ties above excepted): "
              f"{ {u: t.tolist() for u, t in t_gpu.items()} }; prefix hits "
              f"{gst['prefix_hit_blocks']}, chunk steps {gst['chunk_steps']}, decode steps "
              f"{gst['decode_steps']} (CPU {cst['decode_steps']}), B6/B7 launches {fired}")
        del cpu, gpu
    del gpu_model, cpu_model
    torch.cuda.empty_cache()


def phase_paged_serve(torch, Engine, ServeConfig, Request, TO, KVQ, blocks, kernels, model,
                      cfg, label="13", kv_tie=KV_TIE):
    print(f"== phase {label}: full-width {cfg.name} ({cfg.dtype}) served paged: 8 requests "
          f"sharing a 192-token system prompt + 2 chunked 320-token prompts, 8 lanes on 129 "
          f"blocks")
    import numpy as np

    n_layers = cfg.n_layers
    reqs = _shared_requests(Request, cfg.vocab_size, n_shared=8, sys_len=192, tail=16,
                            n_long=2, long_len=320, new=16, seed=13)
    chunk = 256  # the 320-token prompts prefill in chunks
    results = {}
    for kv in (None, "kv8"):
        name = "float" if kv is None else "kv8"
        eng = Engine(model, ServeConfig(max_len=512, batch_size=4, max_active=8, paged=True,
                                        kv_block_size=16, chunk_prefill_tokens=chunk,
                                        kv_quant=kv), device="cuda")
        if eng.kv_blocks != 4 * 32 + 1:
            raise AssertionError(f"kv_blocks {eng.kv_blocks}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        # ---- this slice's main path: counts from 0 over exactly this run ----
        tape = GuardTape(eng, cfg.vocab_size)
        _reset_launches(kernels)
        out = eng.serve(reqs)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in kernels.items()}
        bf16_launches = {k: fn.bf16_launches for k, fn in kernels.items()
                         if hasattr(fn, "bf16_launches")}
        st = dict(eng.last_stats)
        peak = torch.cuda.max_memory_allocated()
        tape.close()

        if sorted(out) != list(range(10)) or any(len(t) != 16 for t in out.values()):
            raise AssertionError(f"paged {name} serve did not return 16 tokens each")
        steps = st["decode_steps"]
        paged_k, other = (("paged_flash_attention", "paged_packed_flash_attention")
                          if kv is None else
                          ("paged_packed_flash_attention", "paged_flash_attention"))
        if (launches[paged_k] != n_layers * steps or launches[other]
                or launches["packed_flash_attention"] or launches["dsbp_fused"] <= 0
                or launches["flash_attention"] % n_layers or not launches["flash_attention"]):
            raise AssertionError(f"paged {name} launches {launches} for {steps} decode steps")
        if not (st["max_concurrent"] > 4 and st["stalled_decode_steps"] == 0
                and st["chunked_requests"] == 2 and st["prefix_hit_blocks"] >= 7 * 12
                and st["interleaved_decode_steps"] > 0 and st["completed"]):
            raise AssertionError(f"paged {name} stats {st}")
        if st["blocks_in_use_at_exit"]:
            raise AssertionError(f"paged {name}: {st['blocks_in_use_at_exit']} blocks not "
                                 f"returned")
        bpt = st["kv_bytes_per_token"]
        elem = 2 if cfg.dtype == "bfloat16" else 4  # a float pool's element bytes
        want_bpt = 2 * n_layers * cfg.n_kv_heads * (cfg.d_head * elem if kv is None
                                                     else cfg.d_head + 4)
        if bpt != want_bpt or st["kv_packed"] != (kv is not None):
            raise AssertionError(f"paged {name} KV bytes per token {bpt} != {want_bpt}")

        # ---- the dense engine on the same requests, 8 slots ----
        dense = Engine(model, ServeConfig(max_len=512, batch_size=8, kv_quant=kv),
                       device="cuda")
        dense_tape = GuardTape(dense, cfg.vocab_size)
        ref = dense.serve(reqs)
        dense_tape.close()
        dst = dict(dense.last_stats)
        ref_rows = dict(dense_tape.rows)
        if kv is not None:
            # a chunked prompt's prefill attends its K/V as the pool stores
            # them, quantized (JAX's chunked prefill), where the dense
            # prefill attends the fresh float K/V; its reference is a dense
            # serve whose prefill attention reads quantize-dequantized K/V
            # (the two agree bit for bit on the CPU)
            real, spec = blocks.blockwise_attention, KVQ.KV_PRESETS[kv]

            def qdq_attention(q, k, v, **kw):  # exact in the K/V dtype (int8 x pow2)
                return real(q, KVQ.quantize_kv(k, spec).dequantize(k.dtype),
                            KVQ.quantize_kv(v, spec).dequantize(v.dtype), **kw)

            blocks.blockwise_attention = qdq_attention
            qdq_tape = GuardTape(dense, cfg.vocab_size)
            try:
                ref.update(dense.serve([r for r in reqs if len(r.tokens) > chunk]))
            finally:
                blocks.blockwise_attention = real
                qdq_tape.close()
            ref_rows.update(qdq_tape.rows)
        ties, worst = check_recorded(torch, ref, out, ref_rows, tape.rows, kv_tie=kv_tie)
        # with the same rows in every step (one admission group, no chunks,
        # no sharing, all lanes busy to the end), paged and dense compute
        # the same numbers: B6/B7 equal B2/B5 over the same keys bit for bit
        same = _shared_requests(Request, cfg.vocab_size, n_shared=0, sys_len=0, tail=0,
                                n_long=4, long_len=128, new=16, seed=14)
        exact = {}
        for paged in (True, False):
            e = Engine(model, ServeConfig(max_len=512, batch_size=4, paged=paged,
                                          kv_block_size=16, chunk_prefill_tokens=512,
                                          prefix_sharing=False, kv_quant=kv), device="cuda")
            exact[paged] = e.serve(same)
            del e
        for uid in exact[False]:
            if not np.array_equal(exact[True][uid], exact[False][uid]):
                raise AssertionError(f"matched batches, request {uid}: paged "
                                     f"{exact[True][uid]} != dense {exact[False][uid]}")

        # ---- one paged decode step: no KV-sized gather, no KV dequantize ----
        with torch.inference_mode():
            cache = model.init_paged_cache(eng.kv_blocks, 16, kv=eng.kv_spec)
            tables = np.arange(1, 1 + 4 * 32, dtype=np.int32).reshape(4, 32)
            toks = np.stack([r.tokens[:200] for r in reqs[2:6]])
            lens = np.asarray([200, 180, 150, 120], np.int32)
            model.prefill_paged(torch.as_tensor(toks, device="cuda"), cache, tables, 512,
                                lengths=lens, quant=eng.quant)
            step = torch.as_tensor(toks[:, :1], device="cuda")
            live = np.ones(4, np.int32)

            def decode():
                return model.decode_step_paged(step, cache, tables, lens, live, 512, eng.quant)

            view = cfg.n_kv_heads * 512 * cfg.d_head  # one lane's gathered view
            gathers = TO.count_kv_gathers(decode, min_size=view)
            dequants = TO.count_kv_dequants(decode, min_size=view)
        if gathers or dequants:
            raise AssertionError(f"a paged {name} decode step dispatched {gathers} KV-sized "
                                 f"gathers and {dequants} KV-sized dequantizes")
        del cache
        print(f"  {name} pool: {steps} decode steps, {st['chunk_steps']} chunk steps, "
              f"{1e3 * st['decode_time_s'] / steps:.2f} ms/step, decode "
              f"{st['decode_tps']:.1f} tok/s, prefill {st['prefill_time_s']:.3f} s, peak "
              f"{peak / 2**30:.2f} GiB (max_memory_allocated)")
        print(f"  {name} pool: max_concurrent {st['max_concurrent']}, prefix_hit_blocks "
              f"{st['prefix_hit_blocks']}, cow_splits {st['cow_splits']}, chunk_steps "
              f"{st['chunk_steps']}, interleaved_decode_steps {st['interleaved_decode_steps']}, "
              f"stalled_decode_steps {st['stalled_decode_steps']}, block_peak_used "
              f"{st['block_peak_used']}/128, admission_blocked {st['admission_blocked']}, KV "
              f"bytes per token {bpt:.0f}")
        print(f"  {name} pool launches: {launches} (per decode step: B6/B7 {n_layers}; "
              f"B2 {n_layers} per admission prefill)")
        print(f"  dense batch-8 serve of the same requests: {dst['decode_steps']} steps, "
              f"{1e3 * dst['decode_time_s'] / dst['decode_steps']:.2f} ms/step, prefill "
              f"{dst['prefill_time_s']:.3f} s; tokens equal to paged up to near ties in "
              f"{len(ties)} of {len(reqs)} streams (top-2 gaps "
              f"{sorted(round(g, 4) for _, _, g, _ in ties)})")
        print(f"  served logits, paged vs dense{' (chunked streams: qdq prefill)' if kv else ''}"
              f", largest difference up to each stream's first differing token, of "
              f"max|logit|: { {u: round(w, 4) for u, w in worst.items()} }")
        print(f"  matched batches (4 x 128-token prompts, 16 tokens, one group, no chunks, "
              f"no sharing): paged == dense token for token")
        print(f"  one paged decode step dispatches 0 KV-sized gathers and 0 KV-sized "
              f"int8->float conversions outside the kernels")
        results[name] = {"launches": launches, "bf16_launches": bf16_launches, "stats": st,
                         "peak": peak, "out": out, "rows": dict(tape.rows), "reqs": reqs}
        del eng, dense
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 16: self-speculative decoding (the MSB-slice draft, verify, rollback)
# ---------------------------------------------------------------------------

class SpecTape:
    """A speculative serve's record: for every emitted token the logit row
    it was drawn from (an admission or chunk step's sampled batch, or the
    round's verify row of its lane and position), and B1's launches by
    their M, split into draft steps (the decode steps a round makes),
    verify passes (T = spec_k + 1 tokens) and the rest.  It wraps the
    engine's sampling, completion test and admission, the model's steps
    and the B1 wrapper's entry in ``kernels.ops``; :meth:`close` undoes
    every wrapper."""

    def __init__(self, eng, vocab: int, TO):
        import collections

        self.rows: dict = {}
        self.b1_m = collections.Counter()    # (tag, M) -> B1 launches
        self.calls = collections.Counter()   # tag -> model step calls
        model, spec_t = eng.model, eng.scfg.spec_k + 1
        batch, emit, lanes, tag, verify, count = [], [], [], ["other"], [None], {}
        sample, done = eng._sample, eng._done
        self._undo = []

        def patch(obj, name, make):
            orig = getattr(obj, name)
            setattr(obj, name, make(orig))
            self._undo.append((obj, name, orig))

        def take_sample(orig):
            def f(logits, gen, **kw):
                batch[:] = [logits[:, :vocab].float().cpu()]
                emit[:] = range(logits.shape[0])
                verify[0] = None
                return orig(logits, gen, **kw)
            return f

        def lane_of(r):
            for i, l in enumerate(lanes[0]):
                if l is r or (isinstance(l, dict) and l["req"] is r):
                    return i
            raise AssertionError(f"request {r.uid} holds no lane")

        def take_done(orig):
            def f(t, emitted, r):
                if verify[0] is None:
                    row = batch[0][emit.pop(0)]
                else:
                    j = count.get(r.uid, 0)
                    count[r.uid] = j + 1
                    row = verify[0][lane_of(r), j]
                if int(row.argmax()) != t:
                    raise AssertionError(f"spec tape out of step at request {r.uid}")
                self.rows.setdefault(r.uid, []).append(row)
                return orig(t, emitted, r)
            return f

        def take_admit(orig):
            def f(cache, queue, free, held, *rest):
                lanes[:] = [held]
                return orig(cache, queue, free, held, *rest)
            return f

        def tagged(name):
            def make(orig):
                def f(tokens, *args, **kw):
                    kind = (name if name != "verify" or tokens.shape[1] == spec_t
                            else "chunk")
                    self.calls[kind] += 1
                    tag[0] = kind
                    try:
                        res = orig(tokens, *args, **kw)
                    finally:
                        tag[0] = "other"
                    if kind == "verify":
                        verify[0] = res[0][..., :vocab].float().cpu()
                        count.clear()
                    return res
                return f
            return make

        def count_b1(orig):
            def f(x, *args, **kw):
                self.b1_m[(tag[0], int(x.shape[0]))] += 1
                return orig(x, *args, **kw)
            return f

        patch(eng, "_sample", take_sample)
        patch(eng, "_done", take_done)
        patch(eng, "_admit_paged" if eng.scfg.paged else "_admit", take_admit)
        for step, name in (("decode_step", "draft"), ("decode_step_paged", "draft"),
                           ("verify_step", "verify"), ("verify_step_paged", "verify"),
                           ("prefill_trunk", "prefill")):
            patch(model, step, tagged(name))
        patch(TO, "dsbp_fused", count_b1)

    def close(self):
        import types

        for obj, name, orig in reversed(self._undo):
            if isinstance(obj, types.ModuleType):
                setattr(obj, name, orig)
            else:  # an instance attribute over the class's method
                delattr(obj, name)


def _containers(model):
    from repro_torch.spec.draft import projection_keys

    return [(pw, pw.ka.data_ptr()) for _, pw in projection_keys(model)]


def trace_round(torch, eng, toks, lens, kinds: dict) -> dict:
    """Device time by kernel over ONE speculation round of the engine
    (prefilled with ``toks``, one warm round first), in a torch.profiler
    window outside every timed pass; the idle share is 1 - busy / the
    window's host wall time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        lg, cache, _ = eng.model.prefill(torch.as_tensor(toks, device=eng.device), 512,
                                         lengths=lens, quant=eng.quant, kv=eng.kv_spec)
        pos = torch.as_tensor(lens, dtype=torch.int32, device=eng.device)
        tok = torch.argmax(lg[:, -1], dim=-1)
        eng._spec(eng.model, cache, tok, pos)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng._spec(eng.model, cache, tok, pos)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    by = {k: [0.0, 0] for k in (*kinds, "other")}
    for e in device_events(prof):
        us = e.self_device_time_total
        kind = next((k for k, pats in kinds.items() if any(p in e.key for p in pats)), "other")
        by[kind][0] += us / 1e3
        by[kind][1] += e.count
    busy = sum(v[0] for v in by.values())
    out = {"wall_ms": wall_ms, "busy_ms": busy,
           "idle_share": 1 - busy / wall_ms if busy else None,
           **{f"{k}_ms": v[0] for k, v in by.items()},
           **{f"{k}_launches": v[1] for k, v in by.items()}}
    if busy:
        print(f"    trace of one round (torch.profiler, outside the timed pass): window "
              f"{wall_ms:.2f} ms, device busy {busy:.2f} ms, idle share "
              f"{out['idle_share']:.3f}; " + ", ".join(
                  f"{k} {v[0]:.3f} ms ({v[1]} kernels)" for k, v in by.items()))
    else:
        print(f"    trace of one round: torch.profiler recorded no device time "
              f"({wall_ms:.2f} ms window)")
    return out


# kernel names (torch.profiler) in a speculation round: B1, B2, and the
# draft view's arithmetic shift of ka (PyTorch's right-shift kernel)
TRACE_ROUND = {"B1": TRACE_FUSED["B1"], "B2": TRACE_FUSED["B2"], "draft_view shift": ("rshift",)}


def _spec_serve(torch, Engine, ServeConfig, TO, kernels, model, cfg, reqs, ref, ref_rows,
                scfg: dict, label: str, trace=None, faults=None, b1_per_step=None,
                attn_layers=None, kv_tie=KV_TIE):
    """One speculative serve of phase 16 against its spec_k=0 reference:
    tokens under phase 9's rule, containers untouched, B1's M per step
    kind and the attention kernels' launches per draft step
    (``b1_per_step`` B1 launches in a model step, default 7 per layer;
    ``attn_layers`` attention layers, default every layer).  Under a fault
    plan (phase 18) a stream that ended early is held against the head of
    its reference."""
    eng = Engine(model, ServeConfig(spec_k=3, spec_draft_method="dsbp_fused", **scfg),
                 device="cuda")
    if eng.spec_report["extra_weight_nbytes"] != 0:
        raise AssertionError(f"{label}: spec_report {eng.spec_report}")
    before = _containers(eng.model)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tape = SpecTape(eng, cfg.vocab_size, TO)
    _reset_launches(kernels)
    try:
        out = eng.serve(reqs, faults=faults)
        torch.cuda.synchronize()
    finally:
        tape.close()
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    st = dict(eng.last_stats)
    if _containers(eng.model) != before:
        raise AssertionError(f"{label}: the engine's containers changed")
    early = {u for u, s in st["request_status"].items() if s not in ("ok", "preempted")}
    ties, worst = check_recorded(torch, ref, out, ref_rows, tape.rows, prefix=early,
                                 kv_tie=kv_tie)
    n_layers = cfg.n_layers if attn_layers is None else attn_layers
    per_step = 7 * cfg.n_layers if b1_per_step is None else b1_per_step
    lanes = eng.lanes if scfg.get("paged") else eng.scfg.batch_size
    rounds, drafts = st["spec_rounds"], tape.calls["draft"]
    if drafts != 3 * rounds or tape.calls["verify"] != rounds:
        raise AssertionError(f"{label}: {drafts} draft steps and {tape.calls['verify']} "
                             f"verify passes for {rounds} rounds")
    m = {k: v for k, v in tape.b1_m.items() if k[0] in ("draft", "verify")}
    want = {("draft", lanes): per_step * drafts, ("verify", 4 * lanes): per_step * rounds}
    want = {k: v for k, v in want.items() if v}  # a float model launches no B1
    if m != want:
        raise AssertionError(f"{label}: B1 launches by (step, M) {m}, want {want}")
    attn = ("paged_packed_flash_attention" if scfg.get("paged") and scfg.get("kv_quant")
            else "paged_flash_attention" if scfg.get("paged")
            else "packed_flash_attention" if scfg.get("kv_quant") else "flash_attention")
    prefills = n_layers * tape.calls["prefill"]
    want_attn = n_layers * drafts + (prefills if attn == "flash_attention" else 0)
    if launches[attn] != want_attn or (attn != "flash_attention"
                                       and launches["flash_attention"] != prefills):
        raise AssertionError(f"{label}: attention launches {launches} for {drafts} draft "
                             f"steps and {tape.calls['prefill']} prefills")
    ms_round = 1e3 * st["decode_time_s"] / rounds
    ms_token = 1e3 * st["decode_time_s"] / st["decode_tokens"]
    print(f"  {label}: {rounds} rounds, accepted_hist {st['accepted_hist']}, mean_accepted "
          f"{st['mean_accepted']:.3f}; {ms_round:.2f} ms per round, {ms_token:.2f} ms per "
          f"committed token; peak {peak / 2**30:.2f} GiB; B1 launches by (step, M) {m}; "
          f"{attn} {launches[attn]} ({n_layers} x {drafts} draft steps"
          f"{' + prefills' if attn == 'flash_attention' else ''}); tokens equal to "
          f"spec_k=0 up to near ties in {len(ties)} of {len(ref)} streams (largest logit "
          f"difference {max(worst.values()):.4f} of max|logit|)")
    res = {"stats": st, "launches": launches, "b1_m": m, "peak": peak, "ms_round": ms_round,
           "ms_token": ms_token, "ties": len(ties), "out": out,
           "worst": max(worst.values())}
    if trace is not None:
        res["trace"] = trace_round(torch, eng, *trace, TRACE_ROUND)
    del eng
    return res


def spec_record(spec: dict, two_layer: dict) -> dict:
    """Phase 16's numbers for its JSON line: per serve its times, peak,
    near ties, acceptance (and the narrow view's, the round's trace)."""
    keys = ("ms_round", "ms_token", "plain_ms_step", "plain_ms_token", "peak", "ties",
            "narrow_view_bytes", "narrow_view_ms", "trace")
    return {"draft_view_ms_per_round": spec["draft_view_ms_per_round"],
            "b1_over_draft_view": spec["b1_draft_view"],
            "two_layer_ms_per_round": two_layer,
            **{label: {**{k: r[k] for k in keys if k in r},
                       "accepted_hist": r["stats"]["accepted_hist"],
                       "mean_accepted": r["stats"]["mean_accepted"]}
               for label, r in spec.items() if isinstance(r, dict) and "stats" in r}}


def phase_spec_cross_device(torch, Engine, ServeConfig, Request, models, cfg):
    print(f"== phase 16a: {CROSS_LAYERS}-layer full width, speculative serve (spec_k 3, draft "
          "dsbp_fused), CPU (plain) vs card (kernels); then the card with draft dsbp_ref")
    import numpy as np

    gpu_model, cpu_model = models
    rng = np.random.default_rng(16)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, n), max_new_tokens=6)
            for i, n in enumerate([5, 17, 9, 12])]
    prompts = {r.uid: r.tokens for r in reqs}
    scfg = dict(max_len=64, batch_size=2, spec_k=3)
    cpu = Engine(cpu_model, ServeConfig(spec_draft_method="dsbp_fused", **scfg), device="cpu")
    gpu = Engine(gpu_model, ServeConfig(spec_draft_method="dsbp_fused", **scfg), device="cuda")
    t_cpu = cpu.serve(reqs)
    h_cpu = cpu.last_stats["accepted_hist"]
    t_gpu = gpu.serve(reqs)
    gst = dict(gpu.last_stats)
    ties = check_streams(torch, t_cpu, t_gpu, prompts, cpu, gpu)
    if not ties and gst["accepted_hist"] != h_cpu:
        raise AssertionError(f"accepted_hist card {gst['accepted_hist']} != CPU {h_cpu}")
    ref = Engine(gpu_model, ServeConfig(spec_draft_method="dsbp_ref", **scfg),
                 device="cuda")
    t_ref = ref.serve(reqs)
    rst = dict(ref.last_stats)
    for uid, t in t_gpu.items():
        if not np.array_equal(t_ref[uid], t):
            raise AssertionError(f"request {uid}: draft dsbp_ref served {t_ref[uid]} != "
                                 f"dsbp_fused {t}")
    out = {name: 1e3 * st["decode_time_s"] / st["spec_rounds"]
           for name, st in (("dsbp_fused", gst), ("dsbp_ref", rst))}
    print(f"  CPU vs card tokens equal (near ties above excepted), accepted_hist "
          f"{gst['accepted_hist']} (CPU {h_cpu}); on the card, ms per round over {CROSS_LAYERS} layers: "
          f"draft dsbp_fused {out['dsbp_fused']:.2f}, draft dsbp_ref {out['dsbp_ref']:.2f} "
          f"(accepted_hist {rst['accepted_hist']}, same tokens)")
    del cpu, gpu, ref
    torch.cuda.empty_cache()
    return out


def phase_spec_serve(torch, TM, Engine, ServeConfig, Request, TO, KVQ, DF, per_tensor_scale,
                     kernels, model, cfg, paged):
    print(f"== phase 16: llama-7b-paper served speculatively (spec_k 3, the MSB-slice draft "
          f"through B1) at full width and {SPEC_LAYERS} layers: phase 5's traffic at draft "
          f"bits 4 and 7, kv8 with kv_draft_bits 6, then phase 13's paged traffic on a float "
          f"and a kv8 pool; B1 over the draft views and their cost at full depth")
    from repro_torch.core.packed import draft_view
    from repro_torch.spec.draft import projection_keys

    # ---- B1 over draft_view containers, bit-equal to plain, at the round's shapes ----
    gen = torch.Generator(device="cuda").manual_seed(16)
    pws = {name: pw for key, pw in projection_keys(model)
           for name in (key.split("/")[-1],) if key.startswith("units/0/")}
    b1 = {}
    for name, m in (("wq", 4), ("w1", 4), ("w2", 4), ("w1", 16), ("w2", 32)):
        pw = pws[name]
        for bits in (4, 7):
            dv = draft_view(pw, bits)
            x = torch.randn(m, pw.padded_k, generator=gen, device="cuda")
            ts = per_tensor_scale(x, pw.cfg.input_cfg.fmt).reshape(1)
            tw = pw.tscale.reshape(-1).contiguous()
            y = DF.dsbp_fused(x, ts, dv.ka, dv.kscale, tw, pw.cfg.input_cfg)
            want = DF.dsbp_fused_plain(x, ts, dv.ka, dv.kscale, tw, pw.cfg.input_cfg)
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                raise AssertionError(f"B1 over draft_view({name}, {bits}) at M={m} != plain")
            if bits == 4:  # cold, as phase 2
                wbytes = dv.ka.numel() + dv.kscale.numel() * 4
                copies = [(x, ts, dv.ka.clone(), dv.kscale.clone(), tw, pw.cfg.input_cfg)
                          for _ in range(max(1, math.ceil(2 * L2_BYTES / wbytes)))]
                ms = cuda_ms(DF.dsbp_fused, copies, iters=30)
                b_ms, _ = bound(m * pw.padded_k * 4 + wbytes + pw.n * 8 + m * pw.n * 4,
                                2.0 * m * pw.padded_k * pw.n, FP16_OPS)
                b1[f"{name} M={m}"] = {"ms": ms, "bound_ms": b_ms}
                del copies
    print("  B1 over draft_view containers (bits 4, 7) bit-equal to plain at M=4 (wq, w1, "
          "w2: the draft's decode shapes), M=16 (w1: the dense verify) and M=32 (w2: the "
          "paged verify); cold ms over the bits-4 views (bound): " + ", ".join(
              f"{k} {v['ms']:.4f} ({v['bound_ms']:.4f})" for k, v in b1.items()))

    # ---- draft_view's cost: every projection's view, once per draft step ----
    conts = [pw for _, pw in projection_keys(model)]

    def views():
        for pw in conts:
            draft_view(pw, 4)

    # ~2,000 small launches and 224 containers built a call: a sleep long
    # enough to hide their enqueue
    view_ms = cuda_ms(views, [()], iters=3, warmup=1, sleep=4 * 10**8)
    print(f"  draft_view of all {len(conts)} projections (one draft step): {view_ms:.2f} ms "
          f"device time; {3 * view_ms:.2f} ms per round (3 draft steps)")

    with torch.inference_mode():  # the kv8 cache of 4 slots x 512, full depth
        cache = model.init_cache(4, 512, kv="kv8")
        narrow_bytes = KVQ.kv_cache_nbytes(cache)
        narrow_ms = cuda_ms(lambda: KVQ.kv_narrow_view(cache, 6), [()], iters=5,
                            sleep=5 * 10**7)
    del cache
    print(f"  kv_narrow_view (kv_draft_bits 6): a {narrow_bytes / 2**20:.1f} MiB copy of the "
          f"kv8 cache (4 slots x 512, 32 layers) per round, {narrow_ms:.3f} ms device time")

    # ---- the serves, at full width and SPEC_LAYERS layers: each held
    # against spec_k 0 on the same model and traffic ----
    cfgs = cfg.replace(n_layers=SPEC_LAYERS)
    smodel = TM.init(cfgs, seed=0, device="cuda", pack="precise")
    toks, lens, reqs = _serve_traffic(Request, cfg.vocab_size)
    out = {"draft_view_ms_per_round": 3 * view_ms, "b1_draft_view": b1,
           "layers": SPEC_LAYERS}
    refs = {}
    for kv, bits, kv_draft in ((None, 4, None), (None, 7, None), ("kv8", 4, 6)):
        if kv not in refs:  # spec_k 0, once per cache
            base = Engine(smodel, ServeConfig(max_len=512, batch_size=4, kv_quant=kv),
                          device="cuda")
            tape = GuardTape(base, cfg.vocab_size)
            try:
                ref = base.serve(reqs)
            finally:
                tape.close()
            refs[kv] = (ref, tape.rows, dict(base.last_stats))
            del base
        ref, rows, bst = refs[kv]
        label = f"dense {kv or 'float'}, draft bits {bits}" + (
            f", kv_draft_bits {kv_draft}" if kv_draft else "")
        res = _spec_serve(torch, Engine, ServeConfig, TO, kernels, smodel, cfgs, reqs, ref,
                          rows, dict(max_len=512, batch_size=4, kv_quant=kv,
                                     spec_draft_bits=bits, kv_draft_bits=kv_draft),
                          label, trace=(toks, lens) if bits == 7 else None)
        res["plain_ms_step"] = 1e3 * bst["decode_time_s"] / bst["decode_steps"]
        res["plain_ms_token"] = 1e3 * bst["decode_time_s"] / bst["decode_tokens"]
        print(f"    spec_k=0, same model and traffic: {res['plain_ms_step']:.2f} ms per step, "
              f"{res['plain_ms_token']:.2f} ms per token")
        if kv_draft:
            res["narrow_view_bytes"], res["narrow_view_ms"] = narrow_bytes, narrow_ms
        out[label] = res
    for name, kv in (("float", None), ("kv8", "kv8")):
        p13 = paged[name]
        scfg = dict(max_len=512, batch_size=4, max_active=8, paged=True, kv_block_size=16,
                    chunk_prefill_tokens=256, kv_quant=kv)
        base = Engine(smodel, ServeConfig(**scfg), device="cuda")
        tape = GuardTape(base, cfg.vocab_size)
        try:
            ref = base.serve(p13["reqs"])
        finally:
            tape.close()
        bst = dict(base.last_stats)
        del base
        res = _spec_serve(torch, Engine, ServeConfig, TO, kernels, smodel, cfgs, p13["reqs"],
                          ref, tape.rows, scfg, f"paged {name} pool")
        print(f"    spec_k=0 ({name} pool, the same model and traffic): "
              f"{1e3 * bst['decode_time_s'] / bst['decode_steps']:.2f} ms per step, "
              f"{1e3 * bst['decode_time_s'] / bst['decode_tokens']:.2f} ms per token")
        out[f"paged {name}"] = res
    del smodel
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 18: fault-tolerant, observable serving (guards, fault plans,
# cancellation and deadlines, the recorder, quantization health, repricing)
# ---------------------------------------------------------------------------

def robust_line(tag: str, rec: dict, t0: float) -> None:
    print("robust (phase 18): " + json.dumps({"case": tag, **rec,
                                              "at_s": time.perf_counter() - t0}))


def device_op_counter(torch):
    """A dispatch mode that counts, exactly, what the code under it sends to
    the card: ``ops`` every ATen op by overload (host ones and views
    included), ``work`` the ops on a CUDA tensor that launch device work, by
    op (views and other aliases, a ``to`` that returns its input, and
    ``empty*`` allocations launch none), and ``copies`` the ops that move
    data between the card and the host (under inference mode ``.cpu()``
    dispatches ``to``, whose schema marks its result an alias).
    Hand-written kernels dispatch no ATen op; their wrappers count their own
    launches.  A tensor made on the card from host data (``torch.as_tensor``)
    is copied outside the dispatcher and is not seen."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    no_kernel = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided"}
    moves = {"to", "_to_copy", "copy_", "_local_scalar_dense"}

    class DeviceOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.work, self.copies = collections.Counter(), collections.Counter(), 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.ops[str(func)] += 1
            ts = [t for t in tree_leaves((args, kwargs, out)) if isinstance(t, torch.Tensor)]
            name = func.overloadpacket.__name__
            alias = any(r.alias_info is not None and not r.alias_info.is_write
                        for r in func._schema.returns)
            if not any(t.is_cuda for t in ts):
                return out
            if name in moves and (name == "_local_scalar_dense"
                                  or not all(t.is_cuda for t in ts)):
                self.copies += 1
            elif (name == "to" and out is not args[0]) or (
                    not alias and name not in no_kernel):
                self.work[name] += 1
            return out

    return DeviceOps()


def trace_serve_window(torch, eng, reqs, kernels, start: int = 2, steps: int = 4) -> dict:
    """What one iteration of the dense serve loop sends to the card: one
    ``eng.serve(reqs)`` with a window from the start of its decode call
    ``start`` to the start of call ``start + steps``, so the window holds
    ``steps`` whole iterations (the model step, the guard, the sampling and
    the tokens' copy to the host, the recorder's hooks and the loop's
    control between steps).  The window must hold no admission, so every
    iteration does the same work.  Returns the serve's tokens too (``out``).

    Exact counts, which the gates read: :func:`device_op_counter` over the
    window (``ops`` / ``work`` / ``copies``) and the hand-written kernels'
    launches (``hand``).  Measured beside them by torch.profiler (device
    activity only) in the same window: device ms and kernels per iteration,
    each kernel name's launches over the window / ``steps``, rounded up.
    The trace loses events and never adds one (on the H100 from 40-45 to
    more than 144 of ~37,200 kernels over a window of 8 steps, spread over many names,
    from run to run), so its kernel count is a lower bound, printed and not
    gated."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    counter = device_op_counter(torch)
    decode, calls, admitted, hand = eng._decode_slots, [0], [], []

    def windowed(pool, active, tok, pos, ctl, rows):
        if calls[0] in (start, start + steps):
            torch.cuda.synchronize()
            admitted.append(ctl.stats["admissions"])
            hand.append({k: fn.launches for k, fn in kernels.items()})
            if calls[0] == start:
                prof.start()
                counter.__enter__()
            else:
                counter.__exit__(None, None, None)
                prof.stop()
        calls[0] += 1
        return decode(pool, active, tok, pos, ctl, rows)

    eng._decode_slots = windowed
    try:
        out = eng.serve([dataclasses.replace(r) for r in reqs])
    finally:
        del eng._decode_slots
        if len(admitted) == 1:  # the serve ended inside the window
            counter.__exit__(None, None, None)
            prof.stop()
    if len(admitted) != 2 or admitted[0] != admitted[1]:
        raise AssertionError(f"profiled serve: admissions {admitted} around the window")
    events = device_events(prof)
    copies = [e for e in events if e.key.startswith(("Memcpy", "Memset"))]
    by_name = {e.key: math.ceil(e.count / steps) for e in events if e not in copies}
    return {"out": out, "ops": counter.ops, "work": counter.work,
            "hand": {k: hand[1][k] - hand[0][k] for k in kernels if hand[1][k] != hand[0][k]},
            "device_ops": (sum(counter.work.values())
                           + sum(hand[1][k] - hand[0][k] for k in kernels)) / steps,
            "host_copies": counter.copies / steps,
            "profiled_kernels": sum(by_name.values()),
            "profiled_launches_in_window": sum(e.count for e in events if e not in copies),
            "profiled_copies": sum(e.count for e in copies) / steps,
            "device_ms": sum(e.self_device_time_total for e in events) / 1e3 / steps}


def phase_robust(torch, Engine, ServeConfig, Request, DF, FA, TO, kernels, model, cfg, ref5,
                 paged):
    print("== phase 18: fault-tolerant, observable serving at full width: guards, fault "
          "plans, cancellation and deadlines, the recorder, quantization health, repricing")
    import numpy as np

    from repro_torch.obs import MetricsRegistry, QuantHealth
    from repro_torch.policy import DSBPPolicy, reprice_from_telemetry
    from repro_torch.serve.engine import REQUEST_STATES
    from repro_torch.serve.faults import FaultPlan, NumericFault
    from repro_torch.spec.draft import projection_keys

    t_phase = time.perf_counter()
    toks, lens, reqs = _serve_traffic(Request, cfg.vocab_size)
    want = ref5["serve"]
    base = dict(max_len=512, batch_size=4)

    def fresh():
        return [dataclasses.replace(r) for r in reqs]

    # ---- 18a: the healthy path, observed and guarded ----
    # four serves of phase 5's traffic back to back, so their step times
    # share conditions; the last also keeps the rows 18b and 18d compare
    # with (its tape adds one copy of each sampled batch to the host)
    runs, engines = {}, {}
    for tag, kw in (("plain", {}), ("observe", dict(observe=True)),
                    ("guard", dict(numeric_guard="quarantine")),
                    ("observe+guard", dict(observe=True, numeric_guard="quarantine"))):
        eng = Engine(model, ServeConfig(**base, **kw), device="cuda")
        tape = GuardTape(eng, cfg.vocab_size) if tag == "observe+guard" else None
        _reset_launches(kernels)
        out = eng.serve(fresh())
        torch.cuda.synchronize()
        ref_rows = tape.close() if tape else None
        st = dict(eng.last_stats)
        for uid, t in want.items():
            if not np.array_equal(out[uid], t):
                raise AssertionError(f"18a {tag}: request {uid} {out[uid]} != phase 5's {t}")
        runs[tag] = {"ms_step": 1e3 * st["decode_time_s"] / st["decode_steps"],
                     "launches": {k: fn.launches for k, fn in kernels.items()
                                  if k in ("dsbp_fused", "flash_attention")},
                     "guard_checks": st["guard_checks"], "decode_steps": st["decode_steps"]}
        engines[tag] = eng
    eng = engines["observe+guard"]
    st, obs = eng.last_stats, eng.obs
    groups = len({e.step for e in obs.trace.events if e.phase == "prefill" and e.kind == "B"})
    if st["guard_checks"] != st["decode_steps"] + groups or st["numeric_faults"]:
        raise AssertionError(f"18a: guard_checks {st['guard_checks']} for "
                             f"{st['decode_steps']} decode steps and {groups} admissions")
    if set(st["request_status"].values()) != {"ok"} or not obs.complete_spans(
            st["request_status"]):
        raise AssertionError(f"18a: statuses {st['request_status']} or open spans")
    snap = obs.metrics.snapshot()
    if MetricsRegistry.from_snapshot(json.loads(json.dumps(snap))).snapshot() != snap:
        raise AssertionError("18a: the metrics snapshot does not round-trip")
    summary = {str(u): {k: (round(v, 4) if isinstance(v, float) else v) for k, v in s.items()}
               for u, s in obs.request_summary().items()}
    # profiled: the first admission group alone, whose decode batches are
    # the whole traffic's while those four requests run (15 steps)
    t_trace = time.perf_counter()
    first = reqs[:base["batch_size"]]
    counts = {tag: trace_serve_window(torch, engines[tag], first, kernels)
              for tag in ("plain", "observe", "guard")}
    t_trace = time.perf_counter() - t_trace
    for tag, c in counts.items():
        got = c.pop("out")
        if set(got) != {r.uid for r in first} or any(
                not np.array_equal(t, want[u]) for u, t in got.items()):
            raise AssertionError(f"18a: the profiled {tag} serve's tokens are not phase 5's")
    plain = counts["plain"]
    extra = {tag: {n: c["work"][n] - plain["work"][n]
                   for n in set(c["work"]) | set(plain["work"])
                   if c["work"][n] != plain["work"][n]}
             for tag, c in counts.items() if tag != "plain"}
    ops_per_step = {t: c["device_ops"] for t, c in counts.items()}
    # observe: exactly the plain loop's ops (every op, host ones too) and
    # kernels; guard: at most the two kernels of its reduction more, and no
    # copy of its own (its flags ride in the tokens' copy)
    if (counts["observe"]["ops"] != plain["ops"] or counts["observe"]["hand"] != plain["hand"]
            or counts["guard"]["hand"] != plain["hand"]
            or not ops_per_step["plain"] < ops_per_step["guard"] <= ops_per_step["plain"] + 2
            or counts["guard"]["host_copies"] != plain["host_copies"]):
        raise AssertionError(f"18a: device ops per serve loop iteration {ops_per_step}, "
                             f"copies { {t: c['host_copies'] for t, c in counts.items()} }, "
                             f"hand-written launches { {t: c['hand'] for t, c in counts.items()} }, "
                             f"extra ops {extra}")
    robust_line("18a healthy dense", {
        "ms_per_decode_step": {"phase 5": ref5["decode_ms"],
                               **{tag: r["ms_step"] for tag, r in runs.items()}},
        "device_ops_per_decode_step": ops_per_step,
        "host_copies_per_decode_step": {t: c["host_copies"] for t, c in counts.items()},
        "extra_ops_per_window": extra,
        "hand_written_launches_per_window": plain["hand"],
        "profiled_kernels_per_decode_step": {t: c["profiled_kernels"]
                                             for t, c in counts.items()},
        "profiled_kernel_launches_per_window": {t: c["profiled_launches_in_window"]
                                                for t, c in counts.items()},
        "profiled_copies_per_decode_step": {t: c["profiled_copies"]
                                            for t, c in counts.items()},
        "device_ms_per_decode_step": {t: c["device_ms"] for t, c in counts.items()},
        "guard_checks": st["guard_checks"], "decode_steps": st["decode_steps"],
        "admission_groups": groups, "launches": runs["observe+guard"]["launches"],
        "trace_s": t_trace,
        "trace_events": len(obs.trace.events), "dropped": obs.trace.dropped,
        "requests": summary}, t_phase)
    print(f"  18a: tokens bit-equal to phase 5 observed and/or guarded; ms per decode step "
          f"{ {t: round(r['ms_step'], 2) for t, r in runs.items()} } (phase 5 in this run "
          f"{ref5['decode_ms']:.2f}; the observe+guard serve carries the logit tape); "
          f"device ops per serve loop iteration {ops_per_step}, profiled kernels (a lower "
          f"bound) { {t: c['profiled_kernels'] for t, c in counts.items()} }")
    del engines

    # ---- 18b: dense faults on phase 5's traffic ----
    def dense_run(tag, guard, plan, requests=None):
        e = Engine(model, ServeConfig(**base, numeric_guard=guard, observe=True),
                   device="cuda")
        gt = GuardTape(e, cfg.vocab_size)
        try:
            o = e.serve(requests or fresh(), faults=plan)
        finally:
            rows = gt.close()
        s = dict(e.last_stats)
        early = {u for u, v in s["request_status"].items() if v not in ("ok", "preempted")}
        ties, _ = check_recorded(torch, want, o, ref_rows, rows, prefix=early)
        exact = sum(np.array_equal(o[u], want[u][:len(o[u])]) for u in want)
        rec = {"status": {str(u): v for u, v in s["request_status"].items()},
               **{k: s[k] for k in ("quarantined", "numeric_faults", "guard_checks",
                                    "fallback_steps", "cancelled", "deadline_expired")},
               "tokens": {str(u): len(v) for u, v in o.items()},
               "streams_exact": exact, "near_ties": len(ties),
               "complete_spans": e.obs.complete_spans(s["request_status"])}
        if not rec["complete_spans"]:
            raise AssertionError(f"18b {tag}: open spans")
        robust_line(f"18b {tag}", rec, t_phase)
        return o, s, e

    lane1 = reqs[1].uid  # slot 1 holds request 1 at decode call 2
    o, s, _ = dense_run("quarantine", "quarantine", FaultPlan(nan_steps={2: (1,)}))
    if s["request_status"][lane1] != "quarantined" or s["quarantined"] != 1 or any(
            v != "ok" for u, v in s["request_status"].items() if u != lane1):
        raise AssertionError(f"18b quarantine: {s['request_status']}")
    if not 0 < len(o[lane1]) < 16:
        raise AssertionError(f"18b quarantine: {len(o[lane1])} tokens kept")
    o, s, _ = dense_run("fallback", "fallback", FaultPlan(nan_steps={2: (1,)}))
    if s["fallback_steps"] != 1 or set(s["request_status"].values()) != {"ok"}:
        raise AssertionError(f"18b fallback: {s['fallback_steps']} {s['request_status']}")
    # 'fallback' keeps every lane, and its retry through dsbp_ref computes
    # B1's numbers: every stream is phase 5's
    for uid, t in want.items():
        if not np.array_equal(o[uid], t):
            raise AssertionError(f"18b fallback: request {uid} {o[uid]} != phase 5's {t}")
    o, s, _ = dense_run("fallback persistent", "fallback",
                        FaultPlan(nan_steps={2: (1,)}, persistent_nan=True))
    if s["fallback_steps"] != 1 or s["request_status"][lane1] != "quarantined":
        raise AssertionError(f"18b persistent: {s['request_status']}")
    e = Engine(model, ServeConfig(**base, numeric_guard="fail-fast"), device="cuda")
    try:
        e.serve(fresh(), faults=FaultPlan(nan_steps={2: (1, 3)}))
        raise AssertionError("18b fail-fast: no NumericFault")
    except NumericFault as err:
        if err.uids != [reqs[1].uid, reqs[3].uid] or e.last_stats["completed"]:
            raise AssertionError(f"18b fail-fast: uids {err.uids}") from err
        robust_line("18b fail-fast", {"uids": err.uids, "step": err.step,
                                      "completed": e.last_stats["completed"]}, t_phase)
    del e
    ctl_reqs = fresh()
    ctl_reqs[6] = dataclasses.replace(ctl_reqs[6], deadline_steps=4)
    o, s, _ = dense_run("cancel + deadline", None,
                        FaultPlan(cancels={5: (reqs[2].uid,)}), requests=ctl_reqs)
    if (s["request_status"][reqs[2].uid] != "cancelled"
            or s["request_status"][reqs[6].uid] != "deadline"
            or s["cancelled"] != 1 or s["deadline_expired"] != 1):
        raise AssertionError(f"18b cancel/deadline: {s['request_status']}")

    # ---- 18c: the paged scheduler under a seeded plan, float then kv8 ----
    for name, kv in (("float", None), ("kv8", "kv8")):
        p13 = paged[name]
        uids = [r.uid for r in p13["reqs"]]
        scfg = ServeConfig(max_len=512, batch_size=4, max_active=8, paged=True,
                           kv_block_size=16, chunk_prefill_tokens=256, kv_quant=kv,
                           numeric_guard="quarantine", observe=True)
        sigs = []
        for rep in range(2 if kv is None else 1):  # the float pool replays its plan
            plan = FaultPlan.seeded(5, uids=uids, n_alloc=2, n_cow=2, n_nan=1, n_cancel=1,
                                    decode_calls=12, alloc_calls=10, steps=8, lanes=4)
            e = Engine(model, scfg, device="cuda")
            gt = GuardTape(e, cfg.vocab_size)
            try:
                o = e.serve([dataclasses.replace(r) for r in p13["reqs"]], faults=plan)
            finally:
                rows = gt.close()
            s = dict(e.last_stats)
            sigs.append(e.obs.trace.signature())
            if rep:
                continue
            status = s["request_status"]
            if not (s["completed"] and set(status) == set(uids) and set(o) == set(uids)
                    and set(status.values()) <= set(REQUEST_STATES)
                    and s["invariant_checks"] > 0 and s["blocks_in_use_at_exit"] == 0):
                raise AssertionError(f"18c {name}: {s}")
            early = {u for u, v in status.items() if v not in ("ok", "preempted")}
            ties, _ = check_recorded(torch, p13["out"], o, p13["rows"], rows, prefix=early)
            injected = {k: e.obs.metrics.value("serve_faults_injected_total", kind=k) or 0
                        for k in plan.injected}
            if injected != plan.injected or not all(
                    plan.injected[k] for k in ("alloc", "cow", "nan", "cancel")):
                raise AssertionError(f"18c {name}: recorder {injected} vs plan "
                                     f"{plan.injected}")
            rec = {"status": {str(u): v for u, v in status.items()},
                   "injected": plan.injected,
                   **{k: s[k] for k in ("preemptions", "resumed", "quarantined", "cancelled",
                                        "invariant_checks", "cow_splits",
                                        "admission_blocked", "decode_steps")},
                   "streams_exact": sum(np.array_equal(o[u], p13["out"][u][:len(o[u])])
                                        for u in uids),
                   "near_ties": len(ties),
                   "trace_events": len(e.obs.trace.events)}
        if sigs[0] != sigs[-1]:
            raise AssertionError(f"18c {name}: the replayed plan gave another trace")
        robust_line(f"18c paged {name}", {**rec, "replayed": len(sigs) == 2}, t_phase)
        del e

    # ---- 18d: speculation (phase 16's dense float traffic, draft bits 7):
    # its first admission group, whose decode batches equal the whole
    # traffic's while those four requests run ----
    spec = dict(max_len=512, batch_size=4, spec_draft_bits=7)
    head = fresh()[:4]
    head_ref = {r.uid: want[r.uid] for r in head}
    for tag, guard, plan in (("mismatch", None, FaultPlan(spec_mismatch_rounds={0, 2, 3})),
                             ("nan", "quarantine", FaultPlan(nan_steps={1: (0,)}))):
        res = _spec_serve(torch, Engine, ServeConfig, TO, kernels, model, cfg,
                          [dataclasses.replace(r) for r in head], head_ref, ref_rows,
                          dict(spec, numeric_guard=guard), f"18d spec {tag}", faults=plan)
        s = res["stats"]
        status = s["request_status"]
        if tag == "mismatch" and (plan.injected["spec"] != 3
                                  or set(status.values()) != {"ok"}):
            raise AssertionError(f"18d mismatch: {plan.injected} {status}")
        if tag == "nan" and (status[reqs[0].uid] != "quarantined" or any(
                v != "ok" for u, v in status.items() if u != reqs[0].uid)):
            raise AssertionError(f"18d nan: {status}")
        robust_line(f"18d spec {tag}", {
            "status": {str(u): v for u, v in status.items()}, "injected": plan.injected,
            "accepted_hist": s["accepted_hist"], "guard_checks": s["guard_checks"],
            "spec_rounds": s["spec_rounds"], "near_ties": res["ties"],
            "ms_round": res["ms_round"]}, t_phase)

    # ---- 18e: quantization health on full-width pools, a trip, repricing ----
    health = {}
    for name, kv in (("float", None), ("kv8", "kv8")):
        with torch.inference_mode():
            _, cache, _ = model.prefill(torch.as_tensor(toks, device="cuda"), 512,
                                        lengths=lens, kv=kv)
            qh = QuantHealth()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            qh.sample_cache(model.cache_tree(cache))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            ent = qh.entries["units.0"]
            if not (ent.total == 2 * cfg.n_layers * 4 * cfg.n_kv_heads * 512 * cfg.d_head
                    and ent.shift_hist.sum() > 0 and ent.nonfinite == 0):
                raise AssertionError(f"18e {name}: {ent.snapshot()}")
            leaf = cache[cfg.n_layers // 4]["k"]
            (leaf.scale if kv else leaf)[1, cfg.n_kv_heads - 1, int(lens[1]) - 1, 0] = \
                float("nan")
            t0 = time.perf_counter()
            culprits = qh.attribute_trip(model.cache_tree(cache))
            trip_ms = 1e3 * (time.perf_counter() - t0)
        if culprits != ["units.0"] or qh.trips() != {"units.0": 1}:
            raise AssertionError(f"18e {name}: attribute_trip {culprits} {qh.trips()}")
        health[name] = {"sample_cache_ms": ms, "attribute_trip_ms": trip_ms,
                        "entry": {k: v for k, v in ent.snapshot().items()
                                  if k != "shift_hist"},
                        "shift_hist_nonzero": {i: int(c) for i, c in enumerate(ent.shift_hist)
                                               if c}}
        del cache
    keys = sorted({k for k, _ in projection_keys(model)})
    pol = DSBPPolicy.uniform("precise", keys).with_kv({"units.0": "kv4"})
    new = reprice_from_telemetry(pol, qh)
    if new.kv_spec_for("units.0").bits != 6 or any(
            new.layers[k] == pol.layers[k] for k in keys):
        raise AssertionError(f"18e reprice: {new.to_json()}")
    robust_line("18e health", {"health": health, "repriced_policy": json.loads(new.to_json())},
                t_phase)
    seconds = time.perf_counter() - t_phase
    print(f"  phase 18 took {seconds:.1f} s")
    torch.cuda.empty_cache()
    return {"seconds": seconds, "runs": runs, "counts": counts, "health": health}


# ---------------------------------------------------------------------------
# phases 17a and 17: the DSBP policy loop (calibrate, price, autotune, serve)
# ---------------------------------------------------------------------------

# the mixed policy of phases 17a and 17: llama-7b-paper's seven projection
# paths (one pattern position: each covers every layer) cycle over four
# Table I presets, and its KV side stores units.0 (every layer) at kv4
MIXED_PRESETS = ("precise", "efficient", "e5m7_fixed", "e5m3_fixed")
# input-side calibration histograms, card vs CPU (phase 17a): the float
# matmuls sum in other orders on the two devices, so a group's ratio can
# cross a bin edge; L1 distance over the counts (a moved count counts twice)
HIST_TOL = 0.01
# continuation scores (sums of log-probs), card vs CPU under the mixed
# policy (phase 17a), relative to max|score|: one last-bit difference can
# move a projection input across an FP8 rounding boundary (phase 9), which
# moves a score by percents; a fault moves it by its own magnitude
SCORE_TIE = 0.05
# a row scored alone against the same row in a batch of its own copies
# (phase 17), relative to max|score|: no kernel's result for a row depends
# on the other rows or their count; only the float lm_head GEMM may sum in
# another order at another M.  Against the same row in a batch of OTHER
# rows the scores may differ by SCORE_TIE: every projection's DSBP input
# path takes one per-tensor scale over all the rows of its GEMM (JAX's
# semantics too), so the batch's largest activation sets how a row's
# smallest inputs round (e4m3 subnormals), an FP8 crossing as above
BATCH_TOL = 1e-5
# phase 17's calibration: batches of rows x tokens
CAL_BATCHES, CAL_ROWS, CAL_SEQ = 4, 4, 128
# phase 17's eval suite: items of each synthetic task before the decided
# subset is taken
EVAL_ITEMS = 64


def mixed_policy(P, PRESETS, keys):
    return P.DSBPPolicy(layers={k: PRESETS[MIXED_PRESETS[i % 4]]
                                for i, k in enumerate(sorted(keys))},
                        kv_layers={"units.0": "kv4"}, kv_default="kv8")


def compare_reports(ref, got) -> float:
    """Phase 17a's rule for two calibration reports of the same weights and
    batches: every count, shape, weight-side statistic and the flops equal;
    the input-side ratio and shift histograms and nz within HIST_TOL.
    Returns the largest histogram distance."""
    import numpy as np

    if sorted(ref.layers) != sorted(got.layers) or ref.meta != got.meta:
        raise AssertionError(f"reports name {sorted(got.layers)} ({got.meta}) vs "
                             f"{sorted(ref.layers)} ({ref.meta})")
    worst = 0.0
    for k, a in ref.layers.items():
        b = got.layers[k]
        same = ("k", "n", "total", "groups", "tokens", "flops", "w_groups", "w_nz_frac")
        if any(getattr(a, f) != getattr(b, f) for f in same) or not np.array_equal(
                a.w_bdyn_hist, b.w_bdyn_hist):
            raise AssertionError(f"{k}: counts or weight-side statistics differ: "
                                 f"{[(f, getattr(a, f), getattr(b, f)) for f in same]}")
        for name, n in (("ratio_hist", a.groups), ("shift_hist", a.nz)):
            d = float(np.abs(getattr(a, name) - getattr(b, name)).sum()) / max(n, 1)
            if d > HIST_TOL:
                raise AssertionError(f"{k}: {name} differs by {d:.4g} of its counts "
                                     f"(limit {HIST_TOL})")
            worst = max(worst, d)
        if abs(a.nz - b.nz) > HIST_TOL * a.total:
            raise AssertionError(f"{k}: nz {b.nz} vs {a.nz}")
    return worst


def compare_scores(ref, got, label: str) -> float:
    """Two engines' (items, choices) scores: within SCORE_TIE * max|score|,
    and the same choice on every item whose reference margin exceeds twice
    the item's difference.  Returns the largest difference relative to
    max|score|."""
    import numpy as np

    top = float(np.abs(ref).max())
    diff = np.abs(ref - got).max(axis=1)
    if float(diff.max()) > SCORE_TIE * top:
        raise AssertionError(f"{label}: scores differ by {float(diff.max())} > "
                             f"{SCORE_TIE} * {top}")
    srt = np.sort(ref, axis=1)
    margin = srt[:, -1] - srt[:, -2]
    bad = (ref.argmax(axis=1) != got.argmax(axis=1)) & (margin > 2 * diff)
    if bad.any():
        raise AssertionError(f"{label}: items {np.flatnonzero(bad).tolist()} change "
                             f"their choice beyond a near tie")
    return float(diff.max()) / top


def phase_policy_cross_device(torch, P, TM, Engine, ServeConfig, Request, PRESETS, kernels,
                              cfg):
    print(f"== phase 17a: {CROSS_LAYERS}-layer full width, the policy loop on the CPU (plain) vs the "
          "card (kernels): calibration report, scores of a decided BoolQ subset and a "
          "mixed-policy serve with a joint KV side")
    import numpy as np

    from repro_torch.eval import boolq_synthetic, harness

    cfg2 = cfg.replace(n_layers=CROSS_LAYERS)
    gpu = TM.init(cfg2, seed=0, device="cuda")
    cpu = TM.Model(cfg2, "cpu")
    cpu.load_state_dict(gpu.state_dict())
    batches = P.synthetic_calibration_batches(cfg2, 2, 2, 64, seed=0)
    reps = {name: P.calibrate(m, cfg2, batches) for name, m in (("cpu", cpu), ("gpu", gpu))}
    worst = compare_reports(reps["cpu"], reps["gpu"])
    print(f"  calibration ({len(batches)} batches of 2 x 64 tokens): {len(reps['gpu'].layers)} "
          f"paths, counts, flops and weight-side statistics equal; input histograms within "
          f"{worst:.4g} of their counts (limit {HIST_TOL})")
    pol = mixed_policy(P, PRESETS, reps["gpu"].layers)
    task = boolq_synthetic(cfg2.vocab_size, 16)
    gold, margins = harness.gold_labels_and_margins(gpu, cfg2, task)
    sub, _ = harness.decided_subset(task, gold, margins, 1.0)
    scfg = ServeConfig(max_len=64, batch_size=4, pack_preset=pol, kv_quant=pol)
    engines = {"gpu": Engine(TM.shared(gpu), scfg, device="cuda")}  # packs on the card
    engines["cpu"] = Engine(copy.deepcopy(engines["gpu"].model).to("cpu"), scfg,
                            device="cpu")
    _reset_launches(kernels)
    scores = {name: harness.score_task(eng, sub) for name, eng in engines.items()}
    torch.cuda.synchronize()
    score_launches = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    rel = compare_scores(scores["cpu"], scores["gpu"], "phase 17a scores")
    print(f"  scores of {len(sub.items)} decided BoolQ items under the mixed policy: card "
          f"vs CPU within {rel:.3g} of max|score| (limit {SCORE_TIE}), the same choices; "
          f"launches {score_launches}")
    toks, lens = _prompts(cfg2.vocab_size, [5, 17, 9, 12], seed=3)
    reqs = [Request(uid=i, tokens=toks[i, :n], max_new_tokens=8) for i, n in enumerate(lens)]
    calls = {}
    for name, eng in engines.items():
        tape = SampleTape(eng, cfg2.vocab_size)
        eng.serve(reqs, max_new_tokens=8)
        calls[name] = tape.close()
        if not eng.last_stats["kv_packed"]:
            raise AssertionError("the joint policy served a float cache")
    first, equal, rel = check_calls(torch, calls["cpu"], calls["gpu"])
    print(f"  mixed policy {list(MIXED_PRESETS)} cycling over the paths, KV units.0 kv4: "
          f"serve of 4 requests, tokens equal under phase 9's rule "
          f"({'no divergence' if first is None else f'a near tie at batch {first}'}), "
          f"{equal} of {len(calls['cpu'])} sampled batches bit-equal, largest logit "
          f"difference {rel:.3g} of max|logit|")
    del engines, cpu, gpu
    return {"hist": worst, "score_rel": rel}


def b1_rung_rows(torch, Q, DF, per_tensor_scale, rungs: dict) -> dict:
    """B1 at w1's decode shape (M=4 K=4096 N=11008) under each named config:
    bit-equal to its plain version, timed cold as phase 2."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    m, k, n = 4, 4096, 11008
    rows = {}
    for name, cfg in rungs.items():
        w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
        pw = Q.pack_weights(w, cfg)
        del w
        x = torch.randn(m, k, generator=gen, device="cuda")
        icfg = cfg.input_cfg
        ts = per_tensor_scale(x, icfg.fmt).reshape(1)
        tw = pw.tscale.reshape(-1).contiguous()
        y = DF.dsbp_fused(x, ts, pw.ka, pw.kscale, tw, icfg)
        ref = DF.dsbp_fused_plain(x, ts, pw.ka, pw.kscale, tw, icfg)
        torch.cuda.synchronize()
        if not torch.equal(y, ref):
            raise AssertionError(f"B1 != plain under {name}: max |diff| "
                                 f"{float((y - ref).abs().max())}")
        wbytes = pw.ka.numel() + pw.kscale.numel() * 4
        copies = [(x, ts, pw.ka.clone(), pw.kscale.clone(), tw, icfg)
                  for _ in range(max(1, math.ceil(2 * L2_BYTES / wbytes)))]
        ms = cuda_ms(DF.dsbp_fused, copies, iters=30)
        plain_ms = cuda_ms(DF.dsbp_fused_plain, copies[:1], iters=3, warmup=1)
        nbytes = m * pw.padded_k * 4 + wbytes + n * 4 + 4 + m * n * 4
        b_ms, b_by = bound(nbytes, 2.0 * m * pw.padded_k * n, FP16_OPS)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "max_abs_err": 0.0, "b_fix": (icfg.b_fix, cfg.weight_cfg.b_fix),
                      "k": icfg.k, "mode": icfg.mode}
        print(f"  B1 M=4 K=4096 N=11008 under {name:10s} (k {icfg.k:g}, B_fix "
              f"{icfg.b_fix}/{cfg.weight_cfg.b_fix}, {icfg.mode}): bit-equal; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
        del pw, copies
    torch.cuda.empty_cache()
    return rows


def b5_kv4_row(torch, FA, KVQ) -> dict:
    """B5 over a kv4 cache at phase 17's serving shape (B=4, H=32, S=512,
    D=128, ragged): bit-equal to B2 over dequantize(), within 1e-5 of
    plain, timed cold as phase 8."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    b, h, s, d = 4, 32, 512, 128
    spec = KVQ.KV_PRESETS["kv4"]
    k = KVQ.quantize_kv(torch.randn(b, h, s, d, generator=gen, device="cuda"), spec)
    v = KVQ.quantize_kv(torch.randn(b, h, s, d, generator=gen, device="cuda"), spec)
    q = torch.randn(b, h, 1, d, generator=gen, device="cuda")
    kv_len = [512, 301, 144, 32]
    return b5_case(torch, FA, "at kv4, decode", q, k, v, kv_len, [n - 1 for n in kv_len])


def _check_containers(torch, DF, per_tensor_scale, model, label: str) -> list:
    """One full-shape decode call (M=4) of B1 on a served container of each
    distinct config in ``model``: bit-equal to its plain version."""
    from repro_torch.spec.draft import projection_keys

    seen = {}
    for key, pw in projection_keys(model):
        seen.setdefault(pw.cfg, (key, pw))
    gen = torch.Generator(device="cuda").manual_seed(len(seen))
    for cfg, (key, pw) in seen.items():
        x = torch.randn(4, pw.k, generator=gen, device="cuda")
        ts = per_tensor_scale(x, cfg.input_cfg.fmt).reshape(1)
        tw = pw.tscale.reshape(-1).contiguous()
        y = DF.dsbp_fused(x, ts, pw.ka, pw.kscale, tw, cfg.input_cfg)
        ref = DF.dsbp_fused_plain(x, ts, pw.ka, pw.kscale, tw, cfg.input_cfg)
        torch.cuda.synchronize()
        if not torch.equal(y, ref):
            raise AssertionError(f"{label}: B1 != plain on {key} ({cfg}): max |diff| "
                                 f"{float((y - ref).abs().max())}")
    return [key for key, _ in seen.values()]


def _step_launches(torch, eng, kernels, toks, lens, max_len: int = 512, TO=None):
    """Each kernel's launches over one full-width decode step of ``eng``.
    With ``TO`` (``kernels.ops``) also returns B1's launches in that step by
    its weight's (K, N), and each kernel's launches in the prefill before
    it: (step, b1_by_shape, prefill)."""
    import collections

    shapes = collections.Counter()
    if TO is not None:
        b1 = TO.dsbp_fused

        def count(x, ts, ka, *rest):
            shapes[tuple(ka.shape)] += 1
            return b1(x, ts, ka, *rest)

        TO.dsbp_fused = count
    try:
        with torch.inference_mode():
            _reset_launches(kernels)
            lg, cache, _ = eng.model.prefill(torch.as_tensor(toks, device="cuda"), max_len,
                                             lengths=lens, quant=eng.quant, kv=eng.kv_spec)
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
            torch.cuda.synchronize()
            prefill = {k: fn.launches for k, fn in kernels.items() if fn.launches}
            _reset_launches(kernels)
            shapes.clear()
            eng.model.decode_step(tok, cache, torch.as_tensor(lens, device="cuda"), eng.quant)
            torch.cuda.synchronize()
    finally:
        if TO is not None:
            TO.dsbp_fused = b1
    step = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    return step if TO is None else (step, dict(shapes), prefill)


def _b1_shapes(model) -> dict:
    """B1's launches per decode step by (K, N), from the model's packed
    containers: every projection but the weight-only ones, the RG-LRU's
    ``wa`` / ``wx`` and the MoE's expert stacks (E, K', N)."""
    import collections

    from repro_torch.core.packed import PackedDSBPWeight

    return dict(collections.Counter(
        tuple(mod.ka.shape) for name, mod in model.named_modules()
        if isinstance(mod, PackedDSBPWeight) and mod.ka.ndim == 2
        and name.rsplit(".", 1)[-1] not in ("wa", "wx")))


def phase_policy(torch, P, TM, Engine, ServeConfig, Request, DF, FA, Q, per_tensor_scale,
                 KVQ, kernels, cfg, ref5, card: str):
    print("== phase 17: the DSBP policy loop at full width: calibrate, price, autotune, "
          "then serve phase 5's traffic under a uniform 'precise', the mixed and the "
          "autotuned policy")
    import numpy as np

    from repro_torch.eval import harness
    from repro_torch.policy.cost import input_bitwidth_ladder

    n_layers = cfg.n_layers
    t0 = time.perf_counter()
    raw = TM.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  {card}: raw f32 model of {n_layers} layers drawn in "
          f"{time.perf_counter() - t0:.2f} s ({sum(p.numel() for p in raw.parameters()) / 1e9:.3f}"
          f" G parameters, resident through the phase for gold labels and trials)")

    # ---- 1. calibrate ----
    torch.cuda.reset_peak_memory_stats()
    batches = P.synthetic_calibration_batches(cfg, CAL_BATCHES, CAL_ROWS, CAL_SEQ, seed=0)
    t0 = time.perf_counter()
    report = P.calibrate(raw, cfg, batches)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    cal_peak = torch.cuda.max_memory_allocated()
    shares = {p: report.flop_share(p) for p in sorted(report.layers)}
    if len(shares) != 7 or abs(sum(shares.values()) - 1.0) > 1e-9:
        raise AssertionError(f"calibration paths {shares}")
    print(f"  calibrate: {CAL_BATCHES} batches of {CAL_ROWS} x {CAL_SEQ} tokens in "
          f"{cal_s:.2f} s, peak {cal_peak / 2**30:.2f} GiB; flop shares sum to "
          f"{sum(shares.values()):.12f}")
    for p, sh in shares.items():
        s = report.layers[p]
        print(f"    {p:18s} K={s.k:5d} N={s.n:5d} flop share {sh:.6f} nz_frac "
              f"{s.nz_frac:.6f} w_nz_frac {s.w_nz_frac:.6f}")

    # ---- 2. price every uniform rung on the macro model ----
    rungs = dict(P.candidate_ladder() + input_bitwidth_ladder((6, 4, 3, 2)))
    priced = {}
    for name, c in rungs.items():
        cost = P.assignment_cost(report, {p: c for p in report.layers})
        priced[name] = {k: cost[k] for k in ("avg_i", "avg_w", "eff_tops_w")}
        print(f"  price {name:10s}: modeled avg I/W {cost['avg_i']:.3f}/{cost['avg_w']:.3f}, "
              f"{cost['eff_tops_w']:.2f} TOPS/W (the paper's 28 nm macro model, not this card)")

    # ---- 3. autotune: gold labels from the raw float model, then the walk ----
    t0 = time.perf_counter()
    tasks, golds = harness.decided_tasks(raw, cfg, EVAL_ITEMS)
    gold_s = time.perf_counter() - t0
    suite = [f"{t.name} {len(t.items)}/{t.meta['subset_of']}" for t in tasks]
    print(f"  eval suite: {suite} decided items (margins >= "
          f"{harness.STANDARD_MARGIN_FLOORS}), gold labels from the float model in "
          f"{gold_s:.2f} s")
    log = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tuned = P.autotune(raw, cfg, report, tasks, ladder=input_bitwidth_ladder((6, 4, 3, 2)),
                       max_drop=0.0, log=log.append)
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    tune_peak = torch.cuda.max_memory_allocated()
    n_trials = sum(len(t["trials"]) for t in tuned.meta["trace"])
    print(f"  autotune (ladder i6/i4/i3/i2 at w7, max_drop 0, full depth, {n_layers} layers):"
          f" {n_trials} trials + the baseline in {tune_s:.2f} s, peak "
          f"{tune_peak / 2**30:.2f} GiB")
    for line in log:
        print(f"    {line}")
    print("  autotuned policy:\n" + "\n".join(f"    {ln}" for ln in tuned.summary().splitlines()))
    m = tuned.meta["modeled"]
    print(f"  accuracies {tuned.meta['final_acc']} against the baseline "
          f"{tuned.meta['baseline_acc']}; modeled avg I/W {m['avg_i']:.3f}/{m['avg_w']:.3f}, "
          f"{m['eff_tops_w']:.2f} TOPS/W (macro model)")
    if any(a < b for a, b in zip(tuned.meta["final_acc"], tuned.meta["baseline_acc"])):
        raise AssertionError("the autotuned policy fell below its floor")

    # ---- 4. serve phase 5's traffic under three policies ----
    toks, lens, reqs = _serve_traffic(Request, cfg.vocab_size)
    mixed = mixed_policy(P, Q.PRESETS, report.layers)
    served = {}
    for label, pol in (("uniform precise", P.DSBPPolicy.uniform("precise")),
                       ("mixed + kv4", mixed), ("autotuned", tuned)):
        eng = Engine(TM.shared(raw), ServeConfig(max_len=512, batch_size=4, pack_preset=pol,
                                                  kv_quant=pol), device="cuda")
        if eng.cfg.quant != "policy" or eng.pack_report["layers_packed"] != 7 * n_layers:
            raise AssertionError(f"{label}: {eng.cfg.quant}, {eng.pack_report}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(kernels)
        # the uniform policy's sampled batches, recorded in its timed run
        tape = SampleTape(eng, cfg.vocab_size) if label == "uniform precise" else None
        out = eng.generate(toks, 16, lengths=lens)
        gst = dict(eng.last_stats)
        got = eng.serve(reqs, max_new_tokens=16)
        torch.cuda.synchronize()
        calls = tape.close() if tape is not None else None
        launches = {k: fn.launches for k, fn in kernels.items() if fn.launches}
        peak = torch.cuda.max_memory_allocated()
        sst = dict(eng.last_stats)
        if out.shape != (4, 16) or sorted(got) != list(range(8)) or any(
                len(t) != 16 for t in got.values()):
            raise AssertionError(f"{label}: generate {out.shape}, serve {sorted(got)}")
        attn = "packed_flash_attention" if eng.kv_spec is not None else "flash_attention"
        if launches.get("dsbp_fused", 0) <= 0 or launches.get(attn, 0) <= 0:
            raise AssertionError(f"{label}: kernels of the path not launched: {launches}")
        step = _step_launches(torch, eng, kernels, toks, lens)
        if step != {"dsbp_fused": 7 * n_layers, attn: n_layers}:
            raise AssertionError(f"{label}: one decode step launched {step}, want B1 "
                                 f"{7 * n_layers} and {attn} {n_layers}")
        keys = _check_containers(torch, DF, per_tensor_scale, eng.model, label)
        res = {"launches": launches, "step_launches": step, "peak": peak,
               "ms_step": 1e3 * sst["decode_time_s"] / sst["decode_steps"],
               "tps": sst["decode_tps"], "gen_ms_step": 1e3 * gst["decode_s"] /
               gst["decode_steps"], "prefill_s": sst["prefill_time_s"],
               "kv_bytes_per_token": sst["kv_bytes_per_token"], "configs": len(keys)}
        print(f"  {label}: serve {sst['decode_steps']} steps, {res['ms_step']:.2f} ms/step, "
              f"{res['tps']:.1f} tok/s, prefill {res['prefill_s']:.3f} s; generate "
              f"{res['gen_ms_step']:.2f} ms/step; peak {peak / 2**30:.2f} GiB; KV bytes per "
              f"token {res['kv_bytes_per_token']:.0f}; one decode step: {step}; B1 bit-equal "
              f"to plain on a served container of each of its {len(keys)} configs; launches "
              f"over generate + serve {launches}")
        if label == "uniform precise":
            if len(calls) != len(ref5["calls"]) or not all(
                    torch.equal(a, b) and torch.equal(ta, tb)
                    for (a, ta), (b, tb) in zip(calls, ref5["calls"])):
                raise AssertionError("the uniform 'precise' policy's sampled logits are not "
                                     "bit-equal to phase 5's preset serve")
            if not np.array_equal(out, ref5["generate"]) or any(
                    not np.array_equal(got[u], t) for u, t in ref5["serve"].items()):
                raise AssertionError("uniform 'precise' policy: streams differ from phase 5's")
            print(f"    every one of {len(calls)} sampled batches bit-equal to phase 5's "
                  f"preset serve (logits and tokens)")
            # the same decode steps as phase 5's trace: device time against host time
            trace = trace_decode(torch, eng, toks, lens, TRACE_FUSED)
            res["trace"] = {k: trace[k] for k in ("wall_ms", "busy_ms", "idle_share")}
            t5 = ref5["trace"]
            print(f"    phase 5's trace in this run: window {t5['wall_ms']:.2f} ms, busy "
                  f"{t5['busy_ms']:.2f} ms, idle share {t5['idle_share']}")
        if label == "mixed + kv4":
            # ---- 5. batch invariance of the scores under the mixed policy ----
            sub = tasks[0]
            seqs = [s for item in sub.items[:8] for s, _ in item.sequences()]
            plens = [p for item in sub.items[:8] for _, p in item.sequences()]
            batched = eng.score_continuations(seqs, plens)
            alone = np.concatenate([eng.score_continuations([s], [p])
                                    for s, p in zip(seqs, plens)])
            copies = np.concatenate([eng.score_continuations([s] * 4, [p] * 4)[:1]
                                     for s, p in zip(seqs, plens)])
            top = float(np.abs(alone).max())
            rel_copies = float(np.abs(copies - alone).max()) / top
            rel = float(np.abs(batched - alone).max()) / top
            if not np.isfinite(batched).all() or rel_copies > BATCH_TOL or rel > SCORE_TIE:
                raise AssertionError(
                    f"scores alone vs in a batch of copies differ by {rel_copies} (limit "
                    f"{BATCH_TOL}), vs in a batch of other rows by {rel} (limit "
                    f"{SCORE_TIE}) of max|score|")
            res.update(batch_rel=rel, copies_rel=rel_copies,
                       bit_equal_rows=int((batched == alone).sum()),
                       bit_equal_copies=int((copies == alone).sum()))
            print(f"    batch invariance: {len(seqs)} sequences, each alone vs in a batch "
                  f"of 4 copies of itself: {res['bit_equal_copies']} bit-equal, largest "
                  f"difference {rel_copies:.3g} of max|score| (limit {BATCH_TOL}); vs in "
                  f"one batch of all {len(seqs)}: {res['bit_equal_rows']} bit-equal, "
                  f"largest difference {rel:.3g} (limit {SCORE_TIE}: the shared "
                  f"per-tensor input scale)")
        served[label] = res
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    # ---- B1 under every rung and preset the phase served, B5 at kv4: times ----
    b1_rows = b1_rung_rows(torch, Q, DF, per_tensor_scale,
                           {**rungs, **{n: Q.PRESETS[n] for n in MIXED_PRESETS}})
    b5_kv4 = b5_kv4_row(torch, FA, KVQ)
    del raw
    gc.collect()
    torch.cuda.empty_cache()
    record = {"card": card, "calibrate_s": cal_s, "calibrate_peak_gib": cal_peak / 2**30,
              "flop_shares": shares, "priced": priced, "gold_s": gold_s,
              "autotune_s": tune_s, "autotune_trials": n_trials,
              "autotune_peak_gib": tune_peak / 2**30, "rungs": tuned.meta["rungs"],
              "baseline_acc": tuned.meta["baseline_acc"], "final_acc": tuned.meta["final_acc"],
              "decided_items": [len(t.items) for t in tasks],
              "serve": {k: {f: (v / 2**30 if f == "peak" else v) for f, v in r.items()}
                        for k, r in served.items()}}
    print("policy (phase 17): " + json.dumps(record))
    return {"served": served, "b1_rows": b1_rows, "b5_kv4": b5_kv4, "record": record}


# ---------------------------------------------------------------------------
# phases 14-15: the mesh, its ranks as processes sharing the one card
# ---------------------------------------------------------------------------

B8_CASES = [(proj, m, k, n, split) for m in (4, 512) for proj, k, n, split in (
    ("wq", 4096, 4096, "column"), ("wo", 4096, 4096, "row"),
    ("w1", 4096, 11008, "column"), ("w2", 11008, 4096, "row"))]


def _clone_packed(pw):
    from repro_torch.core.packed import PackedDSBPWeight

    return PackedDSBPWeight(pw.ka.clone(), pw.kscale.clone(), pw.tscale.clone(),
                            pw.bits.clone(), k=pw.k, n=pw.n, group_size=pw.group_size,
                            cfg=pw.cfg)


def _b8_rank(mesh, cases):
    """Phase 14 on one rank: each case's weight and activation drawn from
    one seeded generator on every rank, B8 on this rank's shard, the
    output assembled and held against B8's plain version (B1's plain
    version on the whole weight) and against B1 on the whole weight; then
    the whole call timed on every rank in lockstep, and B1 on the shard,
    the plain version and one all_reduce of the output timed."""
    import numpy as np
    import torch

    from repro_torch.core import quantized as Q
    from repro_torch.core.formats import per_tensor_scale
    from repro_torch.core.packed import pack_weights_sharded
    from repro_torch.kernels import dsbp_fused as DF
    from repro_torch.kernels import ops as TO

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, cfg = mesh.device, Q.PRESETS["precise"]
    icfg = cfg.input_cfg
    msz, c = mesh.shape["model"], mesh.coords["model"]
    rows = []
    for idx, (proj, m, k, n, split) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(140 + idx)
        w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
        x = torch.randn(m, k, generator=gen, device=dev)
        pw = Q.pack_weights(w, cfg)
        if split == "column":
            local, xl, k_axis, n_axis = pack_weights_sharded(w, cfg, mesh), x, None, "model"
            cols = slice(c * n // msz, (c + 1) * n // msz)
        else:
            ks = slice(c * k // msz, (c + 1) * k // msz)
            local, xl, k_axis, n_axis = pw.slice(rows=ks), x[:, ks].contiguous(), "model", None
            cols = slice(0, n)
        del w

        def call(xx, ww, k_axis=k_axis, n_axis=n_axis):
            return TO.dsbp_matmul_fused_sharded(xx, ww, mesh, k_axis=k_axis, n_axis=n_axis)

        full = torch.zeros(m, n, device=dev)
        full[:, cols] = call(xl, local)
        if n_axis is not None:
            mesh.all_reduce(full, "sum", n_axis)
        ts = per_tensor_scale(x, icfg.fmt).reshape(1)
        tw = pw.tscale.reshape(-1).contiguous()
        plain = DF.dsbp_fused_plain(x, ts, pw.ka, pw.kscale, tw, icfg)  # B8's plain version
        ref = DF.dsbp_fused(x, ts, pw.ka, pw.kscale, tw, icfg)  # B1, whole weight
        torch.cuda.synchronize()
        a = full.cpu().numpy()
        held = {}
        for name, want in (("plain", plain), ("B1", ref)):
            b = want.cpu().numpy()
            diff = np.abs(a - b)
            held[name] = (int((diff > 0).sum()), float((diff / np.spacing(np.abs(b))).max()),
                          float(diff.max()))
            n_diff, ulps, _ = held[name]
            # column-parallel is exact per column; a row-parallel sum may
            # round where the f32 group-order sum does
            if (split == "column" and n_diff) or not ulps <= 4:
                raise AssertionError(f"B8 {proj} M={m} {split}: {n_diff} elements differ "
                                     f"from {name} on the whole weight, up to {ulps} ulps")
        n_diff, ulps, max_err = held["plain"]
        wbytes = local.ka.numel() + local.kscale.numel() * 4
        copies = [_clone_packed(local)
                  for _ in range(max(1, math.ceil(2 * L2_BYTES / wbytes)))]
        iters = 20 if m <= 4 else 5
        for i in range(2):
            call(xl, copies[i % len(copies)])
        torch.cuda.synchronize()
        mesh.barrier()
        t0 = time.perf_counter()
        for i in range(iters):
            call(xl, copies[i % len(copies)])
        torch.cuda.synchronize()
        whole_ms = (time.perf_counter() - t0) * 1e3 / iters
        coll_ms = {"cpu": None}
        # the output's all_reduce: of the CUDA tensor (staged through the
        # host by gloo), and of a host copy (gloo alone; NCCL takes none)
        for where in ("cuda", "cpu")[:1 + (torch.distributed.get_backend() == "gloo")]:
            buf = torch.zeros(m, cols.stop - cols.start, device=dev if where == "cuda" else "cpu")
            mesh.barrier()
            t0 = time.perf_counter()
            for _ in range(iters):
                mesh.all_reduce(buf, "sum", "model")
            torch.cuda.synchronize()
            coll_ms[where] = (time.perf_counter() - t0) * 1e3 / iters
        row = None
        if mesh.rank == 0:  # the other rank waits at the barrier: the card is ours
            twl = local.tscale.reshape(-1).contiguous()
            b1_ms = cuda_ms(DF.dsbp_fused, [(xl, ts, cc.ka, cc.kscale, twl, icfg)
                                            for cc in copies], iters=iters)
            plain_ms = cuda_ms(DF.dsbp_fused_plain, [(x, ts, pw.ka, pw.kscale, tw, icfg)],
                               iters=3, warmup=1)
            # both ranks read their shards through the one card: the whole weight
            nbytes = pw.ka.numel() + pw.kscale.numel() * 4 + m * k * 4 + m * n * 4 + n * 4
            b_ms, b_by = bound(nbytes, 2.0 * m * pw.padded_k * n, FP16_OPS)
            row = {"proj": proj, "M": m, "K": k, "N": n, "split": split, "n_diff": n_diff,
                   "ulps": ulps, "max_abs_err": max_err, "n_diff_b1": held["B1"][0],
                   "ulps_b1": held["B1"][1], "ms": whole_ms,
                   "b1_shard_ms": b1_ms, "collective_ms": coll_ms["cuda"],
                   "host_collective_ms": coll_ms["cpu"], "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by}
        mesh.barrier()
        rows.append(row)
        del pw, local, copies, full, ref, plain
        torch.cuda.empty_cache()
    return rows


def phase_b8(torch):
    print("== phase 14: B8 dsbp_fused_sharded_call on a (1, 2) mesh of two ranks, "
          "against its plain version and B1 on the whole weight")
    from repro_torch.launch.mesh import spawn

    rows = spawn(_b8_rank, (1, 2), B8_CASES, device="cuda", deadline_s=600)[0]
    for r in rows:
        print(f"  B8 {r['proj']} M={r['M']:3d} K={r['K']:5d} N={r['N']:5d} {r['split']:6s}: "
              f"{r['n_diff']} elements differ from plain (max {r['ulps']:.1f} ulps), "
              f"{r['n_diff_b1']} from B1 (max {r['ulps_b1']:.1f}); whole call "
              f"{r['ms']:.4f} ms on rank 0, B1 on its shard {r['b1_shard_ms']:.4f} ms, one "
              f"all_reduce of the output {r['collective_ms']:.4f} ms (of a host copy "
              f"{r['host_collective_ms']} ms), plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def _mesh_serve_rank(mesh, n_layers):
    """Phases 15 / 15b on one rank: build (one rank at a time draws the
    whole seeded model and keeps its shards), then phase 5's traffic
    through generate and serve at 4 slots with the launch counts from 0
    and its sampled batches recorded (:class:`SampleTape`: a clone of each
    sampled batch, no second pass: the batches are held bit-equal to one
    device's, which a run that did not repeat itself would fail)."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import dsbp_fused as DF
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as TM
    from repro_torch import policy as P
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama-7b-paper").replace(n_layers=n_layers)
    scfg = ServeConfig(max_len=512, batch_size=4, mesh_shape=tuple(mesh.shape.values()))
    t0 = time.perf_counter()
    eng = None
    for turn in range(mesh.size):
        if mesh.rank == turn:
            eng = Engine(TM.init(cfg, seed=0, device=mesh.device), scfg, device=mesh.device)
            gc.collect()
            torch.cuda.empty_cache()
        mesh.barrier()
    t_build = time.perf_counter() - t0
    toks, lens, reqs = _serve_traffic(Request, cfg.vocab_size)
    kernels = {"dsbp_fused": DF.dsbp_fused, "dsbp_fused_sharded_call": DF.dsbp_fused_sharded_call,
               "flash_attention": FA.flash_attention}
    torch.cuda.reset_peak_memory_stats()
    # ---- the mesh's main path: counts from 0 over exactly this run ----
    _reset_launches(kernels)
    tape = SampleTape(eng, cfg.vocab_size)
    out = eng.generate(toks, 16, lengths=lens)
    gst = dict(eng.last_stats)
    served = eng.serve(reqs, max_new_tokens=16)
    torch.cuda.synchronize()
    calls = tape.close()
    launches = {k: fn.launches for k, fn in kernels.items()}
    sst = dict(eng.last_stats)
    layer = eng.model.layers[0]
    return {"generate": out, "serve": served, "calls": calls, "gen_stats": gst,
            "serve_stats": sst, "launches": launches, "build_s": t_build,
            "peak": torch.cuda.max_memory_allocated(), "pool_size": sst["pool_size"],
            "q_heads": layer.attn.wq.n // cfg.d_head, "kv_heads": layer.kv_heads(cfg),
            "shards": {name: tuple(getattr(layer.attn if name[1] in "qkvo" else layer.ffn,
                                           name).ka.shape)
                       for name in ("wq", "wk", "wv", "wo", "w1", "w3", "w2")},
            "lm_head": tuple(eng.model.lm_head.shape)}


def _merge_calls(ranks, shape, n_ref_rows):
    """The sampled batches of a mesh run as one engine's: a batch each data
    rank sampled for its own rows is their rows in data order; a batch
    every rank sampled whole (an admission) is data rank 0's."""
    d, m = shape
    firsts = [ranks[i * m]["calls"] for i in range(d)]
    merged = []
    for i, (lg, tok) in enumerate(firsts[0]):
        if lg.shape[0] == n_ref_rows[i]:
            merged.append((lg, tok))
        else:
            import torch

            merged.append((torch.cat([f[i][0] for f in firsts]),
                           torch.cat([f[i][1] for f in firsts])))
    return merged


def phase_mesh_reference(torch, TM, Engine, ServeConfig, Request, DF, FA, cfg):
    """Phase 15b's single-device reference: 2 layers at full width from the
    ranks' seed, phase 5's traffic at 4 slots, its sampled batches
    recorded."""
    eng = Engine(TM.init(cfg.replace(n_layers=2), seed=0, device="cuda"),
                 ServeConfig(max_len=512, batch_size=4), device="cuda")
    toks, lens, reqs = _serve_traffic(Request, cfg.vocab_size)
    DF.dsbp_fused.launches = 0
    FA.flash_attention.launches = 0
    tape = SampleTape(eng, cfg.vocab_size)
    out = eng.generate(toks, 16, lengths=lens)
    served = eng.serve(reqs, max_new_tokens=16)
    torch.cuda.synchronize()
    calls = tape.close()
    sst = dict(eng.last_stats)
    launches = {"dsbp_fused": DF.dsbp_fused.launches,
                "flash_attention": FA.flash_attention.launches}
    ref = {"generate": out, "serve": served, "calls": calls, "launches": launches,
           "decode_ms": 1e3 * sst["decode_time_s"] / sst["decode_steps"]}
    del eng
    torch.cuda.empty_cache()
    return ref


def check_mesh_calls(torch, ref, got, rel: float):
    """What the mesh promises against one device, in every recorded
    sampled batch: equal tokens, and finite logits within ``rel`` *
    max|logit| of the reference's (``rel`` 0: bit-equal).  On a failure
    phase 9's near-tie rule is run over the same batches and its verdict
    printed with it, to tell a near tie from a fault.  Returns (batches
    with bit-equal logits, largest difference relative to max|logit|)."""
    if len(ref) != len(got):
        raise AssertionError(f"{len(got)} sampled batches vs {len(ref)}")
    worst, equal = 0.0, 0
    for i, ((a, ta), (b, tb)) in enumerate(zip(ref, got)):
        if a.shape != b.shape:
            raise AssertionError(f"batch {i}: logits {tuple(b.shape)} vs {tuple(a.shape)}")
        top, delta = float(a.abs().max()), float((a - b).abs().max())
        worst = max(worst, delta / top)
        equal += bool(torch.equal(a, b))
        if not (torch.isfinite(b).all() and delta <= rel * top and torch.equal(ta, tb)):
            try:
                first = check_calls(torch, ref, got)[0]
                why = "phase 9's near-tie rule would pass (" + (
                    "no token diverges)" if first is None else f"a near tie at batch {first})")
            except AssertionError as e:
                why = f"phase 9's near-tie rule fails too: {e}"
            raise AssertionError(
                f"batch {i}: logits differ by {delta} (limit {rel} * {top}), tokens "
                f"{'equal' if torch.equal(ta, tb) else 'differ'}; {why}")
    return equal, worst


def phase_mesh_serve(torch, ref, shape, n_layers, phase, rel):
    import numpy as np

    from repro_torch.launch.mesh import spawn

    ranks = spawn(_mesh_serve_rank, shape, n_layers, device="cuda", deadline_s=900)
    r0 = ranks[0]
    calls = _merge_calls(ranks, shape, [lg.shape[0] for lg, _ in ref["calls"]])
    equal, worst = check_mesh_calls(torch, ref["calls"], calls, rel)
    gst, sst = r0["gen_stats"], r0["serve_stats"]
    for res in ranks:
        if not np.array_equal(res["generate"], ref["generate"]) or any(
                not np.array_equal(res["serve"][u], t) for u, t in ref["serve"].items()):
            raise AssertionError(f"phase {phase}: equal sampled batches, unequal streams")
    for res in ranks:
        ln = res["launches"]
        if not (ln["dsbp_fused_sharded_call"] == ln["dsbp_fused"] == ref["launches"]["dsbp_fused"]
                and ln["flash_attention"] == ref["launches"]["flash_attention"]):
            raise AssertionError(f"phase {phase}: launches {ln} against one device's "
                                 f"{ref['launches']}")
    step_ms = 1e3 * sst["decode_time_s"] / sst["decode_steps"]
    cards = "the one card" if torch.cuda.device_count() < len(ranks) else "a card each"
    print(f"  {len(ranks)} ranks on {cards}, built one after another in "
          f"{r0['build_s']:.1f} s; pool {r0['pool_size']} slots; rank 0 holds "
          f"{r0['q_heads']} q / {r0['kv_heads']} KV heads, shards {r0['shards']}, "
          f"lm_head {r0['lm_head']}")
    print(f"  tokens equal to the single device's, every stream on every rank; {equal} "
          f"of {len(calls)} sampled batches with bit-equal logits, largest difference "
          f"{worst:.3g} of max|logit| (limit {rel})")
    print(f"  generate: decode {1e3 * gst['decode_s'] / gst['decode_steps']:.2f} ms/step; "
          f"serve: {sst['decode_steps']} steps, {step_ms:.2f} ms/step (one device: "
          f"{ref['decode_ms']:.2f}), prefill {sst['prefill_time_s']:.3f} s")
    print(f"  collectives per decode step (rank 0): {sst['collectives_per_decode_step']}")
    print(f"  peak memory per rank: {[round(r['peak'] / 2**30, 2) for r in ranks]} GiB")
    print(f"  launches over generate + serve, per rank: {r0['launches']} (one device: "
          f"{ref['launches']})")
    return {"ranks": ranks, "equal": equal, "worst": worst, "step_ms": step_ms}


def mesh_phases(torch, TM, Engine, ServeConfig, Request, DF, FA, cfg, ref5):
    """Phases 14, 15 and 15b, after the caller dropped its models."""
    gc.collect()
    torch.cuda.empty_cache()
    b8 = phase_b8(torch)
    print("== phase 15: full-width llama-7b-paper on a (1, 2) mesh (tensor-parallel, 2 "
          "ranks): phase 5's traffic, held against phase 5")
    # bit-equal: column-parallel GEMMs are exact per column, and the
    # row-parallel sums did not round on the serve's activations (PERF.md)
    mesh15 = phase_mesh_serve(torch, ref5, (1, 2), cfg.n_layers, "15", 0.0)
    ref15b = phase_mesh_reference(torch, TM, Engine, ServeConfig, Request, DF, FA, cfg)
    print("== phase 15b: 2 layers at full width on a (2, 2) mesh (data- and "
          "tensor-parallel, 4 ranks), held against one device")
    phase_mesh_serve(torch, ref15b, (2, 2), 2, "15b", MESH_DATA_REL)
    return b8, mesh15


# ---------------------------------------------------------------------------
# phase 19: the Griffin hybrid (RG-LRU layers, sliding-window rings, tied
# embeddings): recurrentgemma-2b at full width and depth, gemma3-12b reduced
# ---------------------------------------------------------------------------

# the B1 shapes of a decode step (M = 4 lanes): (K, N) and the projections
# that run at it; their launches per step are counted in phases 19 / 19b
# and must cover every shape the served model launches
HYBRID_B1 = (
    ("recurrentgemma-2b", 2560, 2560, "w_gate w_in w_out (rglru), wq wo (attn_local)"),
    ("recurrentgemma-2b", 2560, 7680, "w1 w3"),
    ("recurrentgemma-2b", 2560, 256, "wk wv (MQA)"),
    ("recurrentgemma-2b", 7680, 2560, "w2"),
    ("gemma3-12b", 3840, 4096, "wq"),
    ("gemma3-12b", 3840, 2048, "wk wv"),
    ("gemma3-12b", 4096, 3840, "wo"),
    ("gemma3-12b", 3840, 15360, "w1 w3"),
    ("gemma3-12b", 15360, 3840, "w2"),
)
# recurrentgemma-2b's attention: Hq 10, Hkv 1 (MQA), d_head 256, window 2048;
# phase 19's ragged prompts, two past the window
HYBRID_LENS = [64, 700, 2100, 2600]
# torch.profiler names of a hybrid decode step: B1, B2 and the library
# matmuls (the tied head and the weight-only wa / wx products)
TRACE_HYBRID = {"B1": TRACE_FUSED["B1"], "B2": TRACE_FUSED["B2"],
                "cuBLAS (head, wa/wx)": ("gemv", "gemm", "xmma", "cutlass")}


def phase_hybrid_kernels(torch, Q, DF, FA, KVQ, per_tensor_scale) -> dict:
    """B1 at the hybrids' decode shapes, and B2 (prefill with the window,
    decode on the ring), B5, B6 and B7 at recurrentgemma-2b's attention
    shape, each against its plain version, timed cold."""
    print("== phase 19 (kernels): B1 at recurrentgemma-2b's and gemma3-12b's decode shapes; "
          "B2 / B5 / B6 / B7 at Hq 10, Hkv 1, D 256, window 2048")
    gen = torch.Generator(device="cuda").manual_seed(19)
    b1 = []
    for arch, k, n, proj in HYBRID_B1:
        row = b1_case(torch, Q, DF, per_tensor_scale, gen, 4, k, n)
        b1.append({**row, "arch": arch, "proj": proj})
    torch.cuda.empty_cache()
    hq, hkv, d, win, s_c, bs = 10, 1, 256, 2048, 2048, 16
    b = len(HYBRID_LENS)
    lens = torch.tensor(HYBRID_LENS, dtype=torch.int32, device="cuda")
    attn = {}

    def record(name, ms, plain_ms, lib_ms, nbytes, visible, err, extra=""):
        b_ms, b_by = bound(nbytes, visible * hq * 4 * d, F32_OPS)
        attn[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "max_abs_err": err}
        print(f"  {name:14s} Hq={hq} Hkv={hkv} D={d}: |diff| to plain {err:.3g}{extra}; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})"
              + (f", sdpa {lib_ms:.4f} ms" if lib_ms is not None else ""))

    # prefill: the prompts at once, causal within the 2048-token window
    s = max(HYBRID_LENS)
    q = torch.randn(b, hq, s, d, generator=gen, device="cuda")
    k = torch.randn(b, hkv, s, d, generator=gen, device="cuda")
    v = torch.randn(b, hkv, s, d, generator=gen, device="cuda")
    q0 = torch.zeros(b, dtype=torch.int32, device="cuda")
    o = FA.flash_attention(q, k, v, lens, q0, window=win)
    ref = FA.flash_attention_plain(q, k, v, lens, q0, window=win)
    # a row's queries past its length are pad (past the window they see no
    # key at all: undefined output, which no caller reads)
    real = torch.arange(s, device="cuda")[None, :] < lens[:, None]
    o, ref = o.transpose(1, 2)[real], ref.transpose(1, 2)[real]
    err = float((o - ref).abs().max())
    if not torch.allclose(o, ref, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"B2 prefill with window: kernel vs plain max |diff| {err}")
    mask = FA.attention_mask(lens, q0, s, s, causal=True, window=win)
    nbytes = 2 * q.numel() * 4 + 2 * float(lens.sum()) * hkv * d * 4 + 8 * b
    args = cold_copies(torch, (q, k, v, lens, q0), nbytes)
    ms = cuda_ms(lambda *a: FA.flash_attention(*a, window=win), args, iters=5)
    plain_ms = cuda_ms(lambda *a: FA.flash_attention_plain(*a, window=win), args[:1], iters=2,
                       warmup=1)
    lib_ms = cuda_ms(_sdpa, [(a[0], a[1], a[2], mask[:, None]) for a in args], iters=5)
    record("B2 prefill", ms, plain_ms, lib_ms, nbytes, float(mask.sum()), err)
    del q, k, v, args, mask, o, ref
    torch.cuda.empty_cache()

    # decode on a full ring of S_c = 2048 slots: the query at each prompt's
    # length; a wrapped row passes kv_len = pos + 1 > S_c, which the kernel
    # reads as S_c (the model clamps it itself)
    pos = lens
    kv_len = torch.clamp(pos + 1, max=s_c)
    q = torch.randn(b, hq, 1, d, generator=gen, device="cuda")
    k = torch.randn(b, hkv, s_c, d, generator=gen, device="cuda")
    v = torch.randn(b, hkv, s_c, d, generator=gen, device="cuda")
    o = FA.flash_attention(q, k, v, kv_len, pos)
    wrapped = FA.flash_attention(q, k, v, pos + 1, pos)
    ref = FA.flash_attention_plain(q, k, v, kv_len, pos)
    err = float((o - ref).abs().max())
    if not torch.equal(o, wrapped):
        raise AssertionError("B2 decode: kv_len past the ring != kv_len = S_c")
    if not torch.allclose(o, ref, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"B2 ring decode: kernel vs plain max |diff| {err}")
    mask = FA.attention_mask(kv_len, pos, 1, s_c, causal=True, window=0)
    visible = float(mask.sum())
    nbytes = 2 * q.numel() * 4 + 2 * float(kv_len.sum()) * hkv * d * 4 + 8 * b
    args = cold_copies(torch, (q, k, v, kv_len, pos), nbytes)
    ms = cuda_ms(FA.flash_attention, args, iters=20)
    plain_ms = cuda_ms(FA.flash_attention_plain, args[:1], iters=5)
    lib_ms = cuda_ms(_sdpa, [(a[0], a[1], a[2], mask[:, None]) for a in args], iters=20)
    record("B2 decode", ms, plain_ms, lib_ms, nbytes, visible, err,
           ", kv_len past the ring bit-equal to S_c")

    kv8 = KVQ.KV_PRESETS["kv8"]
    kq, vq = KVQ.quantize_kv(k, kv8), KVQ.quantize_kv(v, kv8)
    pargs = (q, kq.qm, kq.scale, vq.qm, vq.scale, kv_len, pos)
    o5 = FA.packed_flash_attention(*pargs)
    if not torch.equal(o5, FA.flash_attention(q, kq.dequantize(), vq.dequantize(), kv_len, pos)):
        raise AssertionError("B5 ring decode != B2 over dequantize()")
    if not torch.equal(o5, FA.packed_flash_attention(q, kq.qm, kq.scale, vq.qm, vq.scale,
                                                     pos + 1, pos)):
        raise AssertionError("B5 decode: kv_len past the ring != kv_len = S_c")
    ref5 = FA.packed_flash_attention_plain(*pargs)
    err = float((o5 - ref5).abs().max())
    if not torch.allclose(o5, ref5, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"B5 ring decode: kernel vs plain max |diff| {err}")
    nb5 = 2 * q.numel() * 4 + 2 * float(kv_len.sum()) * hkv * (d + 4) + 8 * b
    cold = cold_copies(torch, pargs, nb5)
    ms = cuda_ms(FA.packed_flash_attention, cold, iters=20)
    plain_ms = cuda_ms(FA.packed_flash_attention_plain, [pargs], iters=5)
    record("B5 decode", ms, plain_ms, None, nb5, visible, err,
           ", bit-equal to B2 over dequantize()")
    del cold

    # paged: the same K/V in a pool of 16-slot blocks, each lane's 128 table
    # entries a shuffled set of blocks
    nb = b * (s_c // bs) + 1
    perm = (torch.randperm(nb - 1, generator=gen, device="cuda") + 1).to(torch.int32)
    table = perm.reshape(b, s_c // bs).contiguous()
    flat = table.to(torch.int64).reshape(-1)

    def pool_of(x):  # (B, Hkv, S_c, D) -> pool (NB, Hkv, bs, D) through the table
        p = torch.zeros((nb, *x.shape[1:2], bs, x.shape[-1]), dtype=x.dtype, device="cuda")
        p[flat] = x.reshape(b, x.shape[1], s_c // bs, bs, x.shape[-1]).permute(
            0, 2, 1, 3, 4).reshape(-1, x.shape[1], bs, x.shape[-1])
        return p

    pk, pv = pool_of(k), pool_of(v)
    qk = [pool_of(t) for t in (kq.qm, kq.scale, vq.qm, vq.scale)]
    for kname, fn, fargs, plain, want, kvb in (
            ("B6 decode", FA.paged_flash_attention, (q, pk, pv, table, kv_len, pos),
             FA.paged_flash_attention_plain, o, 4 * d),
            ("B7 decode", FA.paged_packed_flash_attention, (q, *qk, table, kv_len, pos),
             FA.paged_packed_flash_attention_plain, o5, d + 4)):
        got = fn(*fargs)
        if not torch.equal(got, want):
            raise AssertionError(f"{kname} != its dense kernel over the same K/V")
        pl = plain(*fargs)
        err = float((got - pl).abs().max())
        if not torch.allclose(got, pl, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{kname}: kernel vs plain max |diff| {err}")
        nbytes = 2 * q.numel() * 4 + 2 * float(kv_len.sum()) * hkv * kvb + table.numel() * 4
        cold = cold_copies(torch, fargs, nbytes)
        ms = cuda_ms(fn, cold, iters=20)
        plain_ms = cuda_ms(plain, [fargs], iters=5)
        record(kname, ms, plain_ms, None, nbytes, visible, err,
               ", bit-equal to the dense kernel over the same K/V")
        del cold
    del q, k, v, kq, vq, pk, pv, qk
    torch.cuda.empty_cache()
    return {"b1": b1, "attn": attn}


def phase_hybrid_cross_device(torch, TM, Engine, ServeConfig, cfg):
    """19a: 3 layers (rglru, rglru, attn_local) at full width, window 64,
    the same packed weights served on the CPU (plain versions) and the
    card (kernels): greedy tokens equal under phase 9's near-tie rule."""
    print("== phase 19a: recurrentgemma-2b at full width, 3 layers, window 64: CPU (plain) "
          "vs card (kernels)")
    cfg3 = cfg.replace(n_layers=3, window=64)
    gpu_model = TM.Model(cfg3, "cuda")
    gpu_model.load_state_dict(TM.init(cfg3, seed=19, device="cpu").state_dict())
    scfg = ServeConfig(max_len=192, batch_size=2)
    gpu = Engine(gpu_model, scfg, device="cuda")
    cpu = Engine(copy.deepcopy(gpu.model).to("cpu"), scfg, device="cpu")
    toks, lens = _prompts(cfg.vocab_size, [100, 30, 75, 9], seed=19)
    t_cpu = cpu.generate(toks, 10, lengths=lens)
    t_gpu = gpu.generate(toks, 10, lengths=lens)
    prompts = {r: toks[r, :lens[r]] for r in range(len(lens))}
    ties = check_streams(torch, dict(enumerate(t_cpu)), dict(enumerate(t_gpu)), prompts, cpu,
                         gpu)
    from repro_torch.serve.engine import Request

    reqs = [Request(uid=i, tokens=prompts[i], max_new_tokens=6) for i in range(len(lens))]
    s_cpu, s_gpu = cpu.serve(reqs), gpu.serve(reqs)
    ties += check_streams(torch, s_cpu, s_gpu, prompts, cpu, gpu)
    print(f"  generate (lens {lens.tolist()}, past the window) and serve (4 requests, 2 "
          f"slots): CPU vs card tokens equal, {len(ties)} near ties taken: "
          f"{t_gpu.tolist()}")
    del cpu, gpu, gpu_model
    torch.cuda.empty_cache()


def _hybrid_requests(Request, vocab, lens, new, seed, prefix=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, prefix)
    reqs = []
    for i, n in enumerate(lens):
        t = rng.integers(0, vocab, n)
        if prefix and n > prefix:
            t[:prefix] = shared
        reqs.append(Request(uid=i, tokens=t, max_new_tokens=new))
    return reqs


def phase_hybrid(torch, TM, Engine, ServeConfig, Request, TO, FA, kernels, cfg) -> dict:
    """19: recurrentgemma-2b at full width and depth (26 layers), seeded
    weights packed "precise", f32, max_len 4096 (S_c 2048 on the local
    layers)."""
    print("== phase 19: recurrentgemma-2b at full width and depth, packed 'precise': "
          "generate, serve, kv8, paged, speculation, a fallback retry")
    import numpy as np
    from repro_torch.serve.faults import FaultPlan

    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):  # seconds per part of the phase, for its time budget
        torch.cuda.synchronize()
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 2)
        t_lap[0] = now

    t0 = time.perf_counter()
    model = TM.init(cfg, seed=0, device="cuda")
    eng = Engine(model, ServeConfig(max_len=4096, batch_size=4), device="cuda")
    torch.cuda.synchronize()
    rep = eng.pack_report
    print(f"  init + pack {time.perf_counter() - t0:.2f} s: {rep['layers_packed']} "
          f"projections, {rep['raw_nbytes'] / 1e9:.3f} -> {rep['packed_nbytes'] / 1e9:.3f} GB "
          f"(the tied f32 embedding {4 * cfg.padded_vocab_size * cfg.d_model / 1e9:.3f} GB "
          f"of it), avg W bits {rep['avg_w_bits']:.3f}")
    model = eng.model
    n_rec = sum(layer.kind == "rglru" for layer in model.layers)
    n_attn = len(model.layers) - n_rec
    b1_step, attn_step = 6 * n_rec + 7 * n_attn, n_attn
    # the kv8, paged and speculative serves' model: the same seed's first
    # HYBRID_SUB_LAYERS layers (the time limit), counted the same way
    sub = Engine(TM.init(cfg.replace(n_layers=HYBRID_SUB_LAYERS), seed=0, device="cuda"),
                 ServeConfig(max_len=4096, batch_size=4), device="cuda")
    sub_rec = sum(layer.kind == "rglru" for layer in sub.model.layers)
    sub_b1, sub_attn = 6 * sub_rec + 7 * (HYBRID_SUB_LAYERS - sub_rec), HYBRID_SUB_LAYERS - sub_rec
    toks, lens = _prompts(cfg.vocab_size, HYBRID_LENS, seed=191)
    reqs = _hybrid_requests(Request, cfg.vocab_size, [64, 700, 2100, 2600, 300, 1500, 2200,
                                                      900], new=12, seed=192)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lap("init + pack")

    # ---- the hybrid path: counts from 0 over exactly these runs ----
    _reset_launches(kernels)
    tape = SampleTape(eng, cfg.vocab_size)
    out = eng.generate(toks, 16, lengths=lens)
    calls = tape.close()
    gst = dict(eng.last_stats)
    served = eng.serve(reqs)
    sst = dict(eng.last_stats)
    gtape = GuardTape(sub, cfg.vocab_size)  # the sub-depth serves' reference
    sub_served = sub.serve(reqs)
    gtape.close()
    ref_rows = dict(gtape.rows)
    smodel = sub.model
    kv8 = Engine(smodel, ServeConfig(max_len=4096, batch_size=4, kv_quant="kv8"), device="cuda")
    served8 = kv8.serve(reqs)
    kst = dict(kv8.last_stats)
    pcfg = dict(max_len=4096, batch_size=4, max_active=8, paged=True, kv_block_size=16,
                chunk_prefill_tokens=512, prefill_bucket=64)
    preqs = _hybrid_requests(Request, cfg.vocab_size, [208] * 6 + [2300, 2400], new=12,
                             seed=193, prefix=192)
    paged = Engine(smodel, ServeConfig(**pcfg), device="cuda")
    ptape = GuardTape(paged, cfg.vocab_size)
    pout = paged.serve(preqs)
    ptape.close()
    pst = dict(paged.last_stats)
    paged8 = Engine(smodel, ServeConfig(kv_quant="kv8", **pcfg), device="cuda")
    pout8 = paged8.serve(preqs)
    p8st = dict(paged8.last_stats)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the hybrid path")
    for label, st, n in (("paged", pst, launches["paged_flash_attention"]),
                         ("paged kv8", p8st, launches["paged_packed_flash_attention"])):
        if n != sub_attn * st["decode_steps"]:
            raise AssertionError(f"{label}: {n} paged attention launches for "
                                 f"{st['decode_steps']} decode steps of {sub_attn} layers")
    if sorted(pout8) != sorted(pout) or any(len(t) != 12 for t in pout8.values()):
        raise AssertionError("paged kv8 serve did not return 12 tokens for each request")
    lap(f"generate, serve; {HYBRID_SUB_LAYERS} layers: serve, kv8, paged float and kv8")

    # ---- output shape and range, per-step launches ----
    if out.shape != (4, 16) or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"generate output {out.shape} out of range")
    for label, o in (("serve", served), ("sub-depth serve", sub_served),
                     ("kv8 serve", served8)):
        if sorted(o) != list(range(8)) or any(len(t) != 12 for t in o.values()):
            raise AssertionError(f"{label} did not return 12 tokens for each of 8 requests")
    step, b1_shapes, pre = _step_launches(torch, eng, kernels, toks, lens, max_len=4096,
                                          TO=TO)
    if step != {"dsbp_fused": b1_step, "flash_attention": attn_step}:
        raise AssertionError(f"launches in one decode step {step}: want B1 {b1_step}, B2 "
                             f"{attn_step}")
    if b1_shapes != _b1_shapes(model):
        raise AssertionError(f"B1 launches in one decode step by (K, N) {b1_shapes}, the "
                             f"containers give {_b1_shapes(model)}")
    step8 = _step_launches(torch, kv8, kernels, toks, lens, max_len=4096)
    if step8 != {"dsbp_fused": sub_b1, "packed_flash_attention": sub_attn}:
        raise AssertionError(f"kv8 ({HYBRID_SUB_LAYERS} layers): launches in one decode step "
                             f"{step8}")
    if pst["chunked_requests"] != 2 or pst["prefix_hit_blocks"] < 5 * 12 or not pst["completed"]:
        raise AssertionError(f"paged stats {pst}")
    lap("launches per step")

    # ---- ring decode past the window == sequence mode over the whole context ----
    def context(cont, t):  # each prompt followed by the first t tokens of cont
        ctx = np.zeros((4, toks.shape[1] + t), np.int64)
        for r in range(4):
            ctx[r, :lens[r]] = toks[r, :lens[r]]
            ctx[r, lens[r]:lens[r] + t] = cont[r, :t]
        return torch.as_tensor(ctx, device="cuda"), torch.as_tensor(lens + t, device="cuda")

    # (a) the float model (cuBLAS products, the attention kernels), teacher
    # forced: JAX's test_sliding_window_ring_cache_decode at full width
    fmodel = TM.init(cfg.replace(quant=None), seed=0, device="cuda")
    cont = np.random.default_rng(196).integers(0, cfg.vocab_size, (4, 16))
    ring_rel = {}
    with torch.inference_mode():
        _, fcache, _ = fmodel.prefill(torch.as_tensor(toks, device="cuda"), 4096,
                                      lengths=lens)
        posd = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
        for t in range(16):
            lg, fcache = fmodel.decode_step(torch.as_tensor(cont[:, t:t + 1], device="cuda"),
                                            fcache, posd + t)
            if t in (0, 15):
                seq, _, _ = fmodel.prefill_trunk(*context(cont, t + 1))
                seq, lg = seq[..., :cfg.vocab_size], lg[..., :cfg.vocab_size]
                ring_rel[t] = float((seq - lg).abs().max() / seq.abs().max())
    del fmodel, fcache
    torch.cuda.empty_cache()
    if max(ring_rel.values()) > RING_REL:
        raise AssertionError(f"float ring decode vs sequence mode: {ring_rel} of max|logit| "
                             f"> {RING_REL}")
    # (b) the packed model's greedy stream, printed: each decode step
    # quantizes its own inputs (per-tensor scales over 4 rows), where one
    # prefill pass quantizes the whole context at once
    packed_rel = {}
    for t in (1, 15):
        with torch.inference_mode():
            lg, _, _ = model.prefill_trunk(*context(out, t), eng.quant)
        seq = lg[:, 0, :cfg.vocab_size].float().cpu()
        dec = calls[t][0]
        packed_rel[t] = float((seq - dec).abs().max() / dec.abs().max())
    seq_err = packed_rel[1]
    lap("ring decode vs sequence mode")
    print(f"  ring decode past the window (rows at {lens.tolist()} + t, S_c 2048) vs "
          f"Model.prefill_trunk over the whole context: float model, teacher forced, "
          f"{ring_rel[0]:.2e} / {ring_rel[15]:.2e} of max|logit| at decode steps 1 / 16 "
          f"(limit {RING_REL}); the packed greedy stream, not gated: {packed_rel[1]:.4f} "
          f"at step 1 and {packed_rel[15]:.4f} at step 15 (other FP8 input roundings)")

    # ---- matched batches (the 4 prompts past the window, one group, as
    # many lanes as requests): paged == dense token for token, float, kv8
    # and speculative.  A speculative lane that finishes changes the
    # batch its neighbours' inputs are quantized in (its row goes on in
    # a dense pool and freezes in a paged one), so speculative streams
    # are compared over the tokens committed before any lane can finish:
    # the prefill's token and one per round for ceil((new - 1) / 4)
    # rounds ----
    new = 16
    same = _hybrid_requests(Request, cfg.vocab_size, HYBRID_LENS, new=new, seed=194)
    mcfg = dict(max_len=4096, batch_size=4, kv_block_size=16, chunk_prefill_tokens=4096,
                prefix_sharing=False)
    spec3 = dict(spec_k=3, spec_draft_bits=7, spec_draft_method="dsbp_fused")
    horizon = 1 + -(-(new - 1) // 4)
    exact, rows0 = {}, {}
    for label, kw in (("float", {}), ("kv8", {"kv_quant": "kv8"}), ("spec_k 3", spec3)):
        for pg in (False, True):
            e = Engine(smodel, ServeConfig(paged=pg, **mcfg, **kw), device="cuda")
            tape = GuardTape(e, cfg.vocab_size) if (label, pg) == ("float", False) else None
            exact[label, pg] = e.serve(same)
            if tape is not None:
                rows0 = tape.close()
            del e
        n = horizon if kw is spec3 else new
        for uid, t in exact[label, False].items():
            if not np.array_equal(exact[label, True][uid][:n], t[:n]):
                raise AssertionError(f"{label} matched batches, request {uid}: paged "
                                     f"{exact[label, True][uid]} != dense {t} (first {n})")
    spec_equal = sum(np.array_equal(exact["spec_k 3", True][u], t)
                     for u, t in exact["spec_k 3", False].items())
    lap("matched batches")
    # ---- the power of the speculative gates: a planted rollback fault
    # (the dense round's undo_draft skipped, so the verify starts from the
    # drafted recurrent state and ring slots) must fail the matched-batch
    # check; whether phase 9's rule at HYBRID_TIE against spec_k 0 fails it
    # too is printed ----
    e = Engine(smodel, ServeConfig(paged=False, **mcfg, **spec3), device="cuda")
    ftape = SpecTape(e, cfg.vocab_size, TO)
    e.model.undo_draft = lambda cache, saved, pos, n: cache
    try:
        fout = e.serve(same)
    finally:
        del e.model.undo_draft
        ftape.close()
    del e
    planted_same = [u for u, t in exact["spec_k 3", True].items()
                    if np.array_equal(fout[u][:horizon], t[:horizon])]
    if len(planted_same) == len(same):
        raise AssertionError(f"a planted rollback fault (undo_draft skipped) left every "
                             f"stream's first {horizon} tokens equal to the paged round's")
    try:
        check_recorded(torch, exact["float", False], fout, rows0, ftape.rows,
                       kv_tie=HYBRID_TIE)
        planted_rule = None
    except AssertionError as err:
        planted_rule = str(err)
    print(f"  matched batches (lens {HYBRID_LENS}, one group, {new} new tokens): paged == "
          f"dense token for token, float and kv8; spec_k 3 over the first {horizon} tokens "
          f"of each stream ({spec_equal} of {len(same)} streams equal to the end); a planted "
          f"rollback fault (undo_draft skipped) changes {len(same) - len(planted_same)} of "
          f"{len(same)} streams there; phase 9's rule at {HYBRID_TIE} against spec_k 0: "
          + (f"fails it ({planted_rule})" if planted_rule else "passes it"))
    lap("planted fault")
    # ---- speculation (draft bits 7) against spec_k 0, dense and paged ----
    spec = {}
    for label, scfg, rq, ref, rows in (
            ("dense", dict(max_len=4096, batch_size=4, spec_draft_bits=7), reqs, sub_served,
             ref_rows),
            ("paged", dict(pcfg, spec_draft_bits=7), preqs, pout, ptape.rows)):
        spec[label] = _spec_serve(torch, Engine, ServeConfig, TO, kernels, smodel, cfg, rq,
                                  ref, rows, scfg, f"spec_k 3, draft bits 7, {label}, "
                                  f"{HYBRID_SUB_LAYERS} layers", b1_per_step=sub_b1,
                                  attn_layers=sub_attn, kv_tie=HYBRID_TIE)
    lap("speculation")

    # ---- one NaN step under 'fallback': the retry decodes from the pre-step state ----
    fb = Engine(model, ServeConfig(max_len=4096, batch_size=4, numeric_guard="fallback"),
                device="cuda")
    fout = fb.serve(reqs, faults=FaultPlan(nan_steps={2: (1,)}))
    fst = fb.last_stats
    if fst["fallback_steps"] != 1 or set(fst["request_status"].values()) != {"ok"}:
        raise AssertionError(f"fallback: {fst['fallback_steps']} {fst['request_status']}")
    for uid, t in served.items():
        if not np.array_equal(fout[uid], t):
            raise AssertionError(f"fallback: request {uid} {fout[uid]} != unfaulted {t}")

    lap("fallback")
    trace = trace_decode(torch, eng, toks, lens, TRACE_HYBRID, steps=2, max_len=4096)
    lap("trace")
    # the weight-only wa / wx products (dequantize + f32 matmul) of one
    # decode step, timed cold on the served containers
    from repro_torch.models.layers import dense as dense_fn

    rec = [layer.rec for layer in model.layers if layer.kind == "rglru"]
    x = torch.randn(4, 1, cfg.rnn_dim, device="cuda")
    wawx = [(r.wa, x) for r in rec] + [(r.wx, x) for r in rec]
    wawx_ms = cuda_ms(lambda w, xx: dense_fn(w, xx), wawx, iters=len(wawx)) * len(wawx)
    lap("wa / wx timed")
    ms_step = 1e3 * gst["decode_s"] / gst["decode_steps"]
    bpt_ring = 2 * n_attn * cfg.n_kv_heads * cfg.d_head * 4
    print(f"  generate: 4 prompts (lens {lens.tolist()}), 16 new tokens: prefill "
          f"{gst['prefill_s']:.3f} s, {ms_step:.2f} ms per decode step")
    print(f"  serve: 8 requests through 4 slots: {sst['decode_steps']} steps, prefill "
          f"{sst['prefill_time_s']:.3f} s, {1e3 * sst['decode_time_s'] / sst['decode_steps']:.2f}"
          f" ms/step; at {HYBRID_SUB_LAYERS} layers (the kv8, paged and speculative serves' "
          f"depth) kv8: {1e3 * kst['decode_time_s'] / kst['decode_steps']:.2f} ms/step")
    print(f"  paged, {HYBRID_SUB_LAYERS} layers (bs 16, 6 requests sharing a 192-token prefix, "
          f"2 chunked 2300/2400-token "
          f"prompts): {pst['decode_steps']} decode steps, {pst['chunk_steps']} chunk steps, "
          f"prefix hits {pst['prefix_hit_blocks']}, "
          f"{1e3 * pst['decode_time_s'] / pst['decode_steps']:.2f} ms/step")
    bpt_ring8 = 2 * n_attn * cfg.n_kv_heads * (cfg.d_head + 4)
    print(f"  KV bytes: {bpt_ring} per cached position in float ({bpt_ring8} in kv8) "
          f"over {n_attn} ring layers of 2048 slots; last_stats kv_bytes_per_token "
          f"{sst['kv_bytes_per_token']:.0f} (float) / {kst['kv_bytes_per_token']:.0f} (kv8) "
          f"per max_len position; recurrent state "
          f"{n_rec * (cfg.rnn_dim * 4 + (cfg.d_conv - 1) * cfg.rnn_dim * 4)} bytes per lane; "
          f"peak memory {peak / 2**30:.2f} GiB (max_memory_allocated)")
    print(f"  launches over the hybrid path (generate, serve; at {HYBRID_SUB_LAYERS} layers "
          f"serve, kv8, paged float and kv8): {launches}; per decode step B1 {b1_step} (6 x "
          f"{n_rec} rglru + 7 x {n_attn} attn_local; wa / wx weight-only), by (K, N) "
          f"{b1_shapes}, B2 {attn_step}; at {HYBRID_SUB_LAYERS} layers B1 {sub_b1}, B5 / B6 / B7 "
          f"{sub_attn}; per prefill {pre}")
    print(f"  fallback: one NaN step retried through dsbp_ref, every stream bit-equal to "
          f"the unfaulted serve; wa / wx weight-only products {wawx_ms:.3f} ms per decode "
          f"step ({len(wawx)} calls, timed cold)")
    res = {"launches": launches, "b1_step": b1_step, "attn_step": attn_step, "trace": trace,
           "prefill_s": gst["prefill_s"], "decode_ms": ms_step,
           "serve_ms": 1e3 * sst["decode_time_s"] / sst["decode_steps"],
           "kv8_ms": 1e3 * kst["decode_time_s"] / kst["decode_steps"],
           "paged_ms": 1e3 * pst["decode_time_s"] / pst["decode_steps"],
           "peak": peak, "kv_bytes_per_position": bpt_ring, "wawx_ms_step": wawx_ms,
           "seq_vs_ring": seq_err, "ring_float": ring_rel, "ring_packed": packed_rel,
           "b1_by_shape": {f"K={k} N={n}": c for (k, n), c in b1_shapes.items()},
           "prefill_launches": pre, "kv8_step_launches": step8,
           "paged_step_launches": {
               name: launches[name] / st["decode_steps"]
               for name, st in (("paged_flash_attention", pst),
                                ("paged_packed_flash_attention", p8st))},
           "sub_layers": HYBRID_SUB_LAYERS, "sub_b1_step": sub_b1, "sub_attn_step": sub_attn,
           "matched_horizon": horizon, "spec_matched_equal_streams": spec_equal,
           "planted_fault": {"streams_changed": len(same) - len(planted_same),
                             "tie_rule": planted_rule},
           "spec": {k: {"accepted_hist": v["stats"]["accepted_hist"],
                        "mean_accepted": v["stats"]["mean_accepted"],
                        "ms_round": v["ms_round"], "ms_token": v["ms_token"],
                        "ties": v["ties"]} for k, v in spec.items()},
           "seconds_by_part": laps}
    print(f"  seconds by part: {laps}")
    del eng, kv8, paged, paged8, fb, model, sub, smodel
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_hybrid_gemma3(torch, TM, Engine, ServeConfig, Request, TO, kernels, cfg) -> dict:
    """19b: gemma3-12b at full width, one unit of 6 layers (5 attn_local at
    window 1024, 1 attn_full), max_len 2048: local (S_c 1024) and global
    (S_c 2048) rings share one block table."""
    print("== phase 19b: gemma3-12b at full width, 6 layers (5 local at window 1024, 1 "
          "global; reduced from 48), max_len 2048, dense and paged")
    import numpy as np

    cfg6 = cfg.replace(n_layers=6)
    model = TM.init(cfg6, seed=0, device="cuda")
    dense = Engine(model, ServeConfig(max_len=2048, batch_size=4), device="cuda")
    model = dense.model
    reqs = _hybrid_requests(Request, cfg.vocab_size, [1500, 64, 1100, 1900], new=12,
                            seed=195)
    dout = dense.serve(reqs)
    dst = dict(dense.last_stats)
    toks, lens = _prompts(cfg.vocab_size, [len(r.tokens) for r in reqs], seed=195)
    step, b1_shapes, pre = _step_launches(torch, dense, kernels, toks, lens, max_len=2048,
                                          TO=TO)
    if step != {"dsbp_fused": 7 * 6, "flash_attention": 6} or b1_shapes != _b1_shapes(model):
        raise AssertionError(f"gemma3 launches in one decode step {step}, B1 by (K, N) "
                             f"{b1_shapes}; the containers give {_b1_shapes(model)}")
    paged = Engine(model, ServeConfig(max_len=2048, batch_size=4, paged=True,
                                      kv_block_size=16, chunk_prefill_tokens=2048,
                                      prefix_sharing=False), device="cuda")
    if paged._kv_scs != [1024, 2048] or paged._table_width != 128:
        raise AssertionError(f"ring lengths {paged._kv_scs}, table {paged._table_width}")
    b6 = kernels["paged_flash_attention"].launches
    pout = paged.serve(reqs)
    pst = dict(paged.last_stats)
    b6 = kernels["paged_flash_attention"].launches - b6
    if b6 != 6 * pst["decode_steps"]:
        raise AssertionError(f"B6 launches {b6} for {pst['decode_steps']} paged decode steps")
    for uid, t in dout.items():
        if not np.array_equal(pout[uid], t):
            raise AssertionError(f"gemma3 request {uid}: paged {pout[uid]} != dense {t}")
    print(f"  4 requests (lens {[len(r.tokens) for r in reqs]}, three past the 1024 window) "
          f"in one group: paged == dense token for token; dense "
          f"{1e3 * dst['decode_time_s'] / dst['decode_steps']:.2f} ms/step, paged "
          f"{1e3 * pst['decode_time_s'] / pst['decode_steps']:.2f} ms/step, prefill "
          f"{dst['prefill_time_s']:.3f} s; B6 {b6} launches ({pst['decode_steps']} steps x 6 "
          f"layers); one dense decode step {step}, B1 by (K, N) {b1_shapes}; a prefill "
          f"{pre}")
    res = {"b6_launches": b6, "step_launches": step, "prefill_launches": pre,
           "b1_by_shape": {f"K={k} N={n}": c for (k, n), c in b1_shapes.items()},
           "dense_ms": 1e3 * dst["decode_time_s"] / dst["decode_steps"],
           "paged_ms": 1e3 * pst["decode_time_s"] / pst["decode_steps"],
           "prefill_s": dst["prefill_time_s"]}
    del dense, paged, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def hybrid_phases(torch, TM, Engine, ServeConfig, Request, Q, DF, FA, KVQ, TO,
                  per_tensor_scale, get_config, rows=None) -> dict:
    """Phase 19 whole: the kernels at the hybrids' shapes (``rows``, where
    they were timed already), 19a, 19 and 19b; returns their records (one
    ``hybrid (phase 19):`` JSON line printed)."""
    kernels = {"dsbp_fused": DF.dsbp_fused, "flash_attention": FA.flash_attention,
               "packed_flash_attention": FA.packed_flash_attention,
               "paged_flash_attention": FA.paged_flash_attention,
               "paged_packed_flash_attention": FA.paged_packed_flash_attention}
    t0 = time.perf_counter()
    if rows is None:
        rows = phase_hybrid_kernels(torch, Q, DF, FA, KVQ, per_tensor_scale)
    # the paper's "precise" preset on both (their configs carry none)
    rg = get_config("recurrentgemma-2b").replace(quant="precise")
    phase_hybrid_cross_device(torch, TM, Engine, ServeConfig, rg)
    main = phase_hybrid(torch, TM, Engine, ServeConfig, Request, TO, FA, kernels, rg)
    g3 = phase_hybrid_gemma3(torch, TM, Engine, ServeConfig, Request, TO, kernels,
                             get_config("gemma3-12b").replace(quant="precise"))
    # B1's rows carry the launches counted per decode step of the served
    # model (phase 19's 26 layers, 19b's 6), and every shape it launched
    # was timed
    for arch, r, depth in (("recurrentgemma-2b", main, "phase 19, 26 layers"),
                           ("gemma3-12b", g3, "phase 19b, 6 layers")):
        timed = {f"K={x['K']} N={x['N']}": x for x in rows["b1"] if x["arch"] == arch}
        if set(timed) != set(r["b1_by_shape"]):
            raise AssertionError(f"{arch}: B1 launched at {sorted(r['b1_by_shape'])}, timed "
                                 f"at {sorted(timed)}")
        for key, x in timed.items():
            x["launches_per_step"] = r["b1_by_shape"][key]
            x["launches_of"] = f"one decode step, {depth}"
    attn = rows["attn"]
    attn["B2 prefill"]["launches_per_prefill"] = main["prefill_launches"]["flash_attention"]
    attn["B2 decode"]["launches_per_step"] = main["attn_step"]
    # B5 / B6 / B7 run in the serves cut to HYBRID_SUB_LAYERS layers
    attn["B5 decode"]["launches_per_step"] = main["kv8_step_launches"]["packed_flash_attention"]
    for k, name in (("B6 decode", "paged_flash_attention"),
                    ("B7 decode", "paged_packed_flash_attention")):
        attn[k]["launches_per_step"] = main["paged_step_launches"][name]
    for k in ("B5 decode", "B6 decode", "B7 decode"):
        attn[k]["launches_of"] = f"one decode step, {HYBRID_SUB_LAYERS} of 26 layers"
    rec = {"kernels": rows, "recurrentgemma-2b": main, "gemma3-12b (6 layers)": g3,
           "seconds": time.perf_counter() - t0}
    print("hybrid (phase 19): " + json.dumps(rec, default=str))
    return rec


# ---------------------------------------------------------------------------
# phase 20: the MoE family: mixtral-8x7b (GShard top-2 over 8 packed
# weight-only experts, sliding-window rings of 4096) at full width, drawn
# and packed one layer at a time
# ---------------------------------------------------------------------------

# B1's shapes in a mixtral decode step (M = 4 lanes): the attention
# projections; the experts are weight-only (dequantized for cuBLAS), as in
# the reference
MOE_B1 = ((4096, 4096, "wq wo"), (4096, 1024, "wk wv (GQA, 8 KV heads)"))
# torch.profiler names of a mixtral decode step: B1, B2, the expert
# products and the head (cuBLAS)
TRACE_MOE = {"B1": TRACE_FUSED["B1"], "B2": TRACE_FUSED["B2"],
             "cuBLAS (experts, head)": ("gemv", "gemm", "xmma", "cutlass", "bmm")}
# a depth the 20b serves run at (kv8, paged, speculation): full width
MOE_SERVE_LAYERS = 4
# the new tokens of 20a's CPU-vs-card generate (4 prompts)
MOE_CROSS_NEW = 6


def _moe_requests(Request, vocab, lens, new, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [Request(uid=i, tokens=rng.integers(0, vocab, n), max_new_tokens=new)
            for i, n in enumerate(lens)]


def phase_moe_cross_device(torch, TM, Engine, ServeConfig, cfg) -> dict:
    """20a: 2 layers at full width.  The streamed packed init equals init
    followed by pack_weights_int8 bit for bit; the model served on the CPU
    (plain versions) and on the card (kernels): greedy tokens equal under
    phase 9's rule."""
    print("== phase 20a: mixtral-8x7b at full width, 2 layers: init(pack=) == init + "
          "pack_weights_int8; CPU (plain) vs card (kernels)")
    from repro_torch.serve.engine import pack_weights_int8

    cfg2 = cfg.replace(n_layers=2)
    t0 = time.perf_counter()
    want = TM.init(cfg2, seed=20, device="cuda")
    pack_weights_int8(want, "precise")
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    want = {n: t for n, t in list(want.named_parameters()) + list(want.named_buffers())}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = TM.init(cfg2, seed=20, device="cuda", pack="precise")
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    got = list(model.named_parameters()) + list(model.named_buffers())
    if [n for n, _ in got] != list(want):
        raise AssertionError("streamed init: other parameters than init + pack")
    for name, t in got:
        if not torch.equal(t, want[name]):
            raise AssertionError(f"streamed init != init + pack_weights_int8 at {name}")
    del want
    torch.cuda.empty_cache()
    scfg = ServeConfig(max_len=64, batch_size=4)
    gpu = Engine(model, scfg, device="cuda")
    cpu = Engine(copy.deepcopy(gpu.model).to("cpu"), scfg, device="cpu")
    toks, lens = _prompts(cfg.vocab_size, [24, 7, 16, 11], seed=20)
    prompts = {r: toks[r, :lens[r]] for r in range(len(lens))}
    # the CPU's decode step dequantizes 6 expert stacks (~70 GB of host
    # memory traffic): MOE_CROSS_NEW new tokens
    t0 = time.perf_counter()
    t_cpu = cpu.generate(toks, MOE_CROSS_NEW, lengths=lens)
    cpu_s = time.perf_counter() - t0
    t_gpu = gpu.generate(toks, MOE_CROSS_NEW, lengths=lens)
    ties = check_streams(torch, dict(enumerate(t_cpu)), dict(enumerate(t_gpu)), prompts,
                         cpu, gpu)
    print(f"  {len(got)} tensors bit-equal (init + pack {t_pack:.2f} s, streamed "
          f"{t_stream:.2f} s); generate (lens {lens.tolist()}, {MOE_CROSS_NEW} new tokens; CPU "
          f"{cpu_s:.1f} s): CPU vs card tokens equal, {len(ties)} near ties taken: {t_gpu.tolist()}")
    del cpu, gpu, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"tensors_equal": len(got), "init_pack_s": t_pack, "streamed_s": t_stream,
            "ties": len(ties), "cpu_generate_s": cpu_s}


def phase_moe(torch, TM, Engine, ServeConfig, Request, TO, kernels, cfg) -> dict:
    """20: mixtral-8x7b at full width and depth (32 layers), drawn and
    packed one layer at a time ("precise"), f32, max_len 512: phase 5's
    traffic through generate and a dense serve."""
    print("== phase 20: mixtral-8x7b at full width and depth (32 layers), init(pack=): "
          "generate + dense serve of phase 5's traffic")
    from repro_torch.serve.engine import _nbytes

    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):  # seconds per part of the phase, for its time budget
        torch.cuda.synchronize()
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 2)
        t_lap[0] = now

    torch.cuda.reset_peak_memory_stats()
    model = TM.init(cfg, seed=0, device="cuda", pack="precise")
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    lap("init(pack=)")
    packed = _nbytes(model)
    layer_f32 = 4 * sum(p.numel() for p in TM.Model(cfg.replace(n_layers=1), "meta")
                        .layers[0].parameters())
    f32_all = 4 * cfg.padded_vocab_size * cfg.d_model * 2 + cfg.n_layers * layer_f32
    print(f"  init(pack=) {laps['init(pack=)']:.2f} s: {f32_all / 1e9:.1f} GB of f32 draws -> "
          f"{packed / 1e9:.2f} GB packed; peak {init_peak / 1e9:.2f} GB = packed + "
          f"{(init_peak - packed) / 1e9:.2f} GB (one layer in f32: {layer_f32 / 1e9:.2f} GB)")
    if init_peak > packed + 2 * layer_f32:
        raise AssertionError(f"init(pack=) peaked at {init_peak / 1e9:.2f} GB: more than the "
                             f"packed model and two f32 layers")
    eng = Engine(model, ServeConfig(max_len=512, batch_size=4), device="cuda")
    if eng.pack_report is not None or eng.cfg.quant_method != "dsbp_fused":
        raise AssertionError("the engine repacked a packed model")
    toks, lens, reqs = _serve_traffic(Request, cfg.vocab_size)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- the MoE path: counts from 0 over exactly this run ----
    _reset_launches(kernels)
    out = eng.generate(toks, 16, lengths=lens)
    gst = dict(eng.last_stats)
    served = eng.serve(reqs, max_new_tokens=16)
    sst = dict(eng.last_stats)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    lap("generate + serve")
    for name in ("dsbp_fused", "flash_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the MoE path")
    if out.shape != (4, 16) or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"generate output {out.shape} out of range")
    if sorted(served) != list(range(8)) or any(len(t) != 16 for t in served.values()):
        raise AssertionError("serve did not return 16 tokens for each of 8 requests")
    n_layers = cfg.n_layers
    step, b1_shapes, pre = _step_launches(torch, eng, kernels, toks, lens, TO=TO)
    if step != {"dsbp_fused": 4 * n_layers, "flash_attention": n_layers}:
        raise AssertionError(f"launches in one decode step {step}: want B1 {4 * n_layers} "
                             f"(the attention projections), B2 {n_layers}")
    if b1_shapes != _b1_shapes(model):
        raise AssertionError(f"B1 launches in one decode step by (K, N) {b1_shapes}, the "
                             f"containers give {_b1_shapes(model)}")
    lap("launches per step")

    # ---- the MoE FFN of one decode step (4 rows): dequantize + products ----
    moe = moe_step_times(torch, model, cfg)
    moe_ms, deq_ms, deq_bytes = (moe[k] for k in ("moe_ffn_ms_step", "dequantize_ms_step",
                                                  "dequantize_bytes_step"))
    lap("MoE FFN timed")
    trace = trace_decode(torch, eng, toks, lens, TRACE_MOE, steps=2)  # ~0.75 s per step
    lap("trace")
    ms_step = 1e3 * gst["decode_s"] / gst["decode_steps"]
    serve_ms = 1e3 * sst["decode_time_s"] / sst["decode_steps"]
    print(f"  generate: 4 prompts (lens {lens.tolist()}), 16 new tokens: prefill "
          f"{gst['prefill_s']:.3f} s, {ms_step:.2f} ms per decode step")
    print(f"  serve: 8 requests (lens {[len(r.tokens) for r in reqs]}) through 4 slots: "
          f"{sst['decode_steps']} steps, {sst['admissions']} admissions, prefill "
          f"{sst['prefill_time_s']:.3f} s, {serve_ms:.2f} ms/step; peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated)")
    print(f"  launches over generate + serve: {launches}; per decode step B1 {4 * n_layers} "
          f"(wq wk wv wo; the experts weight-only), by (K, N) {b1_shapes}, B2 {n_layers}; "
          f"per prefill {pre}")
    print(f"  the MoE FFN of one decode step (32 layers, 4 rows, top-2 of 8): {moe_ms:.2f} ms "
          f"on the device, of it the 96 expert-stack dequantizes {deq_ms:.2f} ms "
          f"({deq_bytes / 1e9:.1f} GB read + written: bound "
          f"{1e3 * deq_bytes / HBM_BPS:.2f} ms)")
    res = {"init_s": laps["init(pack=)"], "init_peak": init_peak, "packed_bytes": packed,
           "layer_f32_bytes": layer_f32, "launches": launches, "step_launches": step,
           "b1_by_shape": {f"K={k} N={n}": c for (k, n), c in b1_shapes.items()},
           "prefill_launches": pre, "prefill_s": gst["prefill_s"], "decode_ms": ms_step,
           "serve_ms": serve_ms, "serve_prefill_s": sst["prefill_time_s"], "peak": peak,
           "moe_ffn_ms_step": moe_ms, "dequantize_ms_step": deq_ms,
           "dequantize_bytes_step": deq_bytes, "trace": trace, "seconds_by_part": laps}
    print(f"  seconds by part: {laps}")
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def moe_step_times(torch, model, cfg) -> dict:
    """The device time of one decode step's MoE FFN over every layer (4
    rows, each layer's output dropped as the next runs) and of its expert
    stacks' dequantizes alone, with the bytes those read and write."""
    from repro_torch.models.moe import moe_ffn

    x = torch.randn(4, 1, cfg.d_model, device="cuda")
    moes = [layer.moe for layer in model.layers]

    def ffn_step():
        for m in moes:
            moe_ffn(m, x, cfg, no_drop=True)

    def dequantize_step():
        for m in moes:
            for w in ("w1", "w3", "w2"):
                getattr(m, w).dequantize()

    with torch.inference_mode():
        return {"moe_ffn_ms_step": cuda_ms(ffn_step, [()], iters=2, warmup=1, sleep=0),
                "dequantize_ms_step": cuda_ms(dequantize_step, [()], iters=2, warmup=1, sleep=0),
                "dequantize_bytes_step": sum(getattr(m, w).ka.numel() * (1 + 4) for m in moes
                                             for w in ("w1", "w3", "w2"))}


def moe_route_flips(torch, eng, toks, lens, vocab: int, rounds: int) -> dict:
    """The cause behind MOE_TIE, counted: from one cache, ``rounds`` times
    the verify pass over each lane's next 4 tokens (16 rows under one
    per-tensor input scale) against the 4 chained decode steps over the
    same tokens (4 rows each), as a speculative round and spec_k 0 compute
    them.  Returns the top-2 routes compared and flipped (a token whose
    set of two experts differs in a layer), and the logit difference
    relative to max|logit| at the positions with no flip at or before them
    in their lane (held to phase 9's KV_TIE: without a flip only the input
    rounding differs) and at the rest."""
    import numpy as np

    from repro_torch.models import moe as TMOE

    model, quant, b = eng.model, eng.quant, len(lens)
    depth, k = len(model.layers), model.cfg.top_k
    seen, route = [], TMOE.route

    def recorded(*args):
        out = route(*args)
        seen.append(out[0].reshape(-1, k))
        return out

    flips = np.zeros((rounds, depth, b, 4), bool)
    diffs = np.zeros((rounds, b, 4))
    TMOE.route = recorded
    try:
        with torch.inference_mode():
            lg, cache, _ = model.prefill(torch.as_tensor(toks, device=eng.device), 512,
                                         lengths=lens, quant=quant)
            tok = lg[:, -1, :vocab].argmax(-1)
            pos = torch.as_tensor(lens, dtype=torch.int32, device=eng.device)
            for r in range(rounds):
                before = [{n: t.clone() for n, t in c.items()} for c in cache]
                seen.clear()
                chain, rows = [tok], []
                for j in range(4):
                    lg, cache = model.decode_step(chain[-1][:, None], cache, pos + j, quant)
                    rows.append(lg[:, -1, :vocab].float())
                    chain.append(rows[-1].argmax(-1))
                dec, seen[:] = list(seen), []
                vl, _ = model.verify_step(torch.stack(chain[:4], 1), before, pos, quant)
                if len(dec) != 4 * depth or len(seen) != depth:
                    raise AssertionError(f"route calls: {len(dec)} over 4 decode steps, "
                                         f"{len(seen)} in a verify, for {depth} layers")
                for layer in range(depth):
                    ver = seen[layer][:4 * b].reshape(b, 4, k).sort(-1).values
                    for j in range(4):
                        one = dec[j * depth + layer][:b].sort(-1).values
                        flips[r, layer, :, j] = (one != ver[:, j]).any(-1).cpu().numpy()
                ref = torch.stack(rows, 1)
                diffs[r] = ((vl[..., :vocab].float() - ref).abs().amax(-1)
                            / ref.abs().amax(-1)).cpu().numpy()
                tok, pos = chain[4], pos + 4
                del before
    finally:
        TMOE.route = route
    tainted = np.logical_or.accumulate(flips.any(1), axis=-1)
    if diffs[~tainted].max(initial=0.0) > KV_TIE:
        raise AssertionError(f"verify vs decode steps with no route flipped: logits differ "
                             f"by {diffs[~tainted].max()} > {KV_TIE} of max|logit|")
    return {"routes": int(flips.size), "flipped": int(flips.sum()),
            "positions": int(tainted.size), "positions_after_a_flip": int(tainted.sum()),
            "max_rel_diff_no_flip": float(diffs[~tainted].max(initial=0.0)),
            "max_rel_diff_after_a_flip": float(diffs[tainted].max(initial=0.0))}


def phase_moe_serving(torch, TM, Engine, ServeConfig, Request, TO, kernels, cfg) -> dict:
    """20b: full width at MOE_SERVE_LAYERS layers: kv8 (B5), paged float
    and kv8 (B6, B7), paged == dense exactly at matched batches (float,
    kv8, spec_k 3 over the tokens committed before any lane can finish),
    and spec_k 3 at draft bits 7 against spec_k 0 under phase 9's rule
    (MOE_TIE for the packed model), which a planted acceptance fault must
    fail; the route flips behind MOE_TIE counted."""
    import numpy as np

    depth = MOE_SERVE_LAYERS
    print(f"== phase 20b: mixtral-8x7b at full width, {depth} layers: kv8, paged float and "
          f"kv8, matched batches, speculation")
    cfgd = cfg.replace(n_layers=depth)
    model = TM.init(cfgd, seed=0, device="cuda", pack="precise")
    toks, lens, reqs = _serve_traffic(Request, cfg.vocab_size)
    dense = Engine(model, ServeConfig(max_len=512, batch_size=4), device="cuda")
    model = dense.model
    tape = GuardTape(dense, cfg.vocab_size)
    served = dense.serve(reqs, max_new_tokens=16)
    ref_rows = tape.close()
    _reset_launches(kernels)
    kv8 = Engine(model, ServeConfig(max_len=512, batch_size=4, kv_quant="kv8"), device="cuda")
    served8 = kv8.serve(reqs, max_new_tokens=16)
    kst = dict(kv8.last_stats)
    pcfg = dict(max_len=512, batch_size=4, paged=True, kv_block_size=16)
    pst = {}
    for label, kw in (("float", {}), ("kv8", {"kv_quant": "kv8"})):
        e = Engine(model, ServeConfig(**pcfg, **kw), device="cuda")
        pout = e.serve(reqs, max_new_tokens=16)
        pst[label] = dict(e.last_stats)
        if sorted(pout) != list(range(8)) or any(len(t) != 16 for t in pout.values()):
            raise AssertionError(f"paged {label} did not return 16 tokens per request")
        del e
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    for name, n, steps in (("packed_flash_attention", launches["packed_flash_attention"],
                            kst["decode_steps"]),
                           ("paged_flash_attention", launches["paged_flash_attention"],
                            pst["float"]["decode_steps"]),
                           ("paged_packed_flash_attention",
                            launches["paged_packed_flash_attention"], pst["kv8"]["decode_steps"])):
        if n != depth * steps:
            raise AssertionError(f"{name}: {n} launches for {steps} decode steps of {depth} "
                                 f"layers")
    if sorted(served8) != list(range(8)) or any(len(t) != 16 for t in served8.values()):
        raise AssertionError("kv8 serve did not return 16 tokens for each of 8 requests")
    step8 = _step_launches(torch, kv8, kernels, toks, lens)
    if step8 != {"dsbp_fused": 4 * depth, "packed_flash_attention": depth}:
        raise AssertionError(f"kv8: launches in one decode step {step8}")

    # ---- matched batches (the 4 prompts of generate as 4 requests, one
    # group, 4 lanes): paged == dense token for token; speculative streams
    # over the tokens committed before any lane can finish ----
    new = 16
    same = _moe_requests(Request, cfg.vocab_size, lens.tolist(), new, seed=201)
    mcfg = dict(max_len=512, batch_size=4, kv_block_size=16, chunk_prefill_tokens=512,
                prefix_sharing=False)
    spec3 = dict(spec_k=3, spec_draft_bits=7, spec_draft_method="dsbp_fused")
    horizon = 1 + -(-(new - 1) // 4)
    exact = {}
    for label, kw in (("float", {}), ("kv8", {"kv_quant": "kv8"}), ("spec_k 3", spec3)):
        for pg in (False, True):
            e = Engine(model, ServeConfig(paged=pg, **mcfg, **kw), device="cuda")
            exact[label, pg] = e.serve(same)
            del e
        n = horizon if kw is spec3 else new
        for uid, t in exact[label, False].items():
            if not np.array_equal(exact[label, True][uid][:n], t[:n]):
                raise AssertionError(f"{label} matched batches, request {uid}: paged "
                                     f"{exact[label, True][uid]} != dense {t} (first {n})")
    spec_equal = sum(np.array_equal(exact["spec_k 3", True][u], t)
                     for u, t in exact["spec_k 3", False].items())
    # ---- speculation (draft bits 7) against spec_k 0: the packed model
    # under MOE_TIE, the float model (no input quantized: every draft is
    # the target) under phase 9's rule ----
    scfg = dict(max_len=512, batch_size=4, spec_draft_bits=7)
    spec = _spec_serve(torch, Engine, ServeConfig, TO, kernels, model, cfgd, reqs, served,
                       ref_rows, scfg, "spec_k 3, draft bits 7, dense, packed",
                       b1_per_step=4 * depth, attn_layers=depth, kv_tie=MOE_TIE)
    # ---- the power of MOE_TIE: a planted acceptance fault (every draft
    # kept unverified, so a rejected draft's K/V stays in the cache and the
    # verify rows after it are committed) must fail phase 9's rule at
    # MOE_TIE against spec_k 0; at draft bits 4, where drafts are rejected
    # often enough to give the fault rows to corrupt ----
    from repro_torch.spec import decode as SD

    accept, rejected = SD.greedy_accept, []

    def keep_all(draft, target):
        rejected.append(int((accept(draft, target) <= draft.shape[1]).sum()))
        return torch.full((draft.shape[0],), draft.shape[1] + 1, dtype=torch.int64,
                          device=draft.device)

    e = Engine(model, ServeConfig(spec_k=3, spec_draft_method="dsbp_fused",
                                  **dict(scfg, spec_draft_bits=4)), device="cuda")
    ftape = SpecTape(e, cfg.vocab_size, TO)
    SD.greedy_accept = keep_all
    try:
        fout = e.serve(reqs)
    finally:
        SD.greedy_accept = accept
        ftape.close()
    del e
    try:
        check_recorded(torch, served, fout, ref_rows, ftape.rows, kv_tie=MOE_TIE)
    except AssertionError as err:
        planted_rule = str(err)
    else:
        raise AssertionError(f"a planted acceptance fault ({sum(rejected)} rejected drafts "
                             f"kept) passes phase 9's rule at {MOE_TIE} against spec_k 0")
    changed = sum(not np.array_equal(fout[u], t) for u, t in served.items())
    print(f"  planted acceptance fault (draft bits 4, every draft kept: {sum(rejected)} of "
          f"{4 * len(rejected)} lane-rounds kept a rejected draft): {changed} of {len(served)} "
          f"streams changed; phase 9's rule at {MOE_TIE} against spec_k 0 fails it "
          f"({planted_rule[:160]})")
    # ---- what lies behind MOE_TIE: routes that flip between a verify
    # pass and the decode steps it stands for ----
    flips = moe_route_flips(torch, dense, toks, lens, cfg.vocab_size, rounds=8)
    print(f"  route flips, verify (16 rows) vs 4 chained decode steps (4 rows), 8 rounds from "
          f"generate's prompts: {flips['flipped']} of {flips['routes']} top-2 routes flipped "
          f"({depth} layers x 4 lanes x 4 positions x 8 rounds); logits differ by at most "
          f"{flips['max_rel_diff_no_flip']:.4f} of max|logit| at the "
          f"{flips['positions'] - flips['positions_after_a_flip']} positions with no flip at "
          f"or before them, {flips['max_rel_diff_after_a_flip']:.4f} at the "
          f"{flips['positions_after_a_flip']} after a flip")
    fmodel = TM.init(cfgd.replace(quant=None), seed=0, device="cuda")
    fdense = Engine(fmodel, ServeConfig(max_len=512, batch_size=4), device="cuda")
    tape = GuardTape(fdense, cfg.vocab_size)
    fserved = fdense.serve(reqs, max_new_tokens=16)
    frows = tape.close()
    fspec = _spec_serve(torch, Engine, ServeConfig, TO, kernels, fmodel, cfgd, reqs, fserved,
                        frows, scfg, "spec_k 3, dense, float", b1_per_step=0,
                        attn_layers=depth)
    del fdense, fmodel
    print(f"  kv8: {1e3 * kst['decode_time_s'] / kst['decode_steps']:.2f} ms/step; paged "
          f"float / kv8: {1e3 * pst['float']['decode_time_s'] / pst['float']['decode_steps']:.2f}"
          f" / {1e3 * pst['kv8']['decode_time_s'] / pst['kv8']['decode_steps']:.2f} ms/step "
          f"({depth} layers); B5 / B6 / B7 {depth} per decode step")
    print(f"  matched batches (lens {lens.tolist()}, one group, {new} new tokens): paged == "
          f"dense token for token, float and kv8; spec_k 3 over the first {horizon} tokens "
          f"of each stream ({spec_equal} of {len(same)} streams equal to the end)")
    res = {"depth": depth, "launches": launches, "kv8_step_launches": step8,
           "kv8_ms": 1e3 * kst["decode_time_s"] / kst["decode_steps"],
           "paged_ms": {k: 1e3 * v["decode_time_s"] / v["decode_steps"]
                        for k, v in pst.items()},
           "paged_step_launches": {
               "paged_flash_attention": launches["paged_flash_attention"]
               / pst["float"]["decode_steps"],
               "paged_packed_flash_attention": launches["paged_packed_flash_attention"]
               / pst["kv8"]["decode_steps"]},
           "matched_horizon": horizon, "spec_matched_equal_streams": spec_equal,
           "planted_fault": {"rejected_drafts_kept": sum(rejected),
                             "lane_rounds": 4 * len(rejected), "streams_changed": changed,
                             "tie_rule": planted_rule},
           "route_flips": flips,
           "spec": {label: {"accepted_hist": r["stats"]["accepted_hist"],
                            "mean_accepted": r["stats"]["mean_accepted"],
                            "ms_round": r["ms_round"], "ms_token": r["ms_token"],
                            "ties": r["ties"], "worst": r["worst"]}
                    for label, r in (("packed", spec), ("float", fspec))}}
    del dense, kv8, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def moe_kernels(torch, Q, DF, per_tensor_scale) -> list:
    print("== phase 20 (kernels): B1 at mixtral-8x7b's decode shapes")
    gen = torch.Generator(device="cuda").manual_seed(20)
    b1 = [{**b1_case(torch, Q, DF, per_tensor_scale, gen, 4, k, n), "proj": proj}
          for k, n, proj in MOE_B1]
    torch.cuda.empty_cache()
    return b1


def moe_phases(torch, TM, Engine, ServeConfig, Request, Q, DF, FA, TO, per_tensor_scale,
               get_config, card: str, b1=None) -> dict:
    """Phase 20 whole: B1 at mixtral's shapes (``b1``, where they were
    timed already), 20a, 20 and 20b; returns their records (one ``moe
    (phase 20):`` JSON line printed)."""
    kernels = {"dsbp_fused": DF.dsbp_fused, "flash_attention": FA.flash_attention,
               "packed_flash_attention": FA.packed_flash_attention,
               "paged_flash_attention": FA.paged_flash_attention,
               "paged_packed_flash_attention": FA.paged_packed_flash_attention}
    t0 = time.perf_counter()
    if b1 is None:
        b1 = moe_kernels(torch, Q, DF, per_tensor_scale)
    cfg = get_config("mixtral-8x7b").replace(quant="precise")
    cross = phase_moe_cross_device(torch, TM, Engine, ServeConfig, cfg)
    main = phase_moe(torch, TM, Engine, ServeConfig, Request, TO, kernels, cfg)
    serving = phase_moe_serving(torch, TM, Engine, ServeConfig, Request, TO, kernels, cfg)
    # B1's rows carry the launches counted per decode step of the 32-layer
    # model, and every shape it launched was timed
    timed = {f"K={x['K']} N={x['N']}": x for x in b1}
    if set(timed) != set(main["b1_by_shape"]):
        raise AssertionError(f"B1 launched at {sorted(main['b1_by_shape'])}, timed at "
                             f"{sorted(timed)}")
    for key, x in timed.items():
        x["launches_per_step"] = main["b1_by_shape"][key]
        x["launches_of"] = "one decode step, phase 20, 32 layers"
    rec = {"card": card, "b1": b1, "20a": cross, "20": main, "20b": serving,
           "seconds": time.perf_counter() - t0}
    print("moe (phase 20): " + json.dumps(rec, default=str))
    return rec



# ---------------------------------------------------------------------------
# phase 21: the SSD family: mamba2-370m (attention-free: 48 Mamba-2 SSD
# layers, tied embeddings, vocab padded 50,280 -> 50,432) at full width
# and depth
# ---------------------------------------------------------------------------

# B1's shapes in a mamba2-370m step: the fused in-projection (z, x, B, C,
# dt: 2 * 2048 + 2 * 128 + 32 columns, a multiple of 32 but not of 128,
# so the prefill tile ends in a partial column block of 32) and the
# out-projection
SSD_B1 = ((1024, 4384, "w_in"), (2048, 1024, "w_out"))
# torch.profiler names of a mamba2 decode step: B1, and the library
# products (the tied head, the state's C . h contraction)
TRACE_SSD = {"B1": TRACE_FUSED["B1"],
             "cuBLAS (head, C.h)": ("gemv", "gemm", "xmma", "cutlass", "bmm")}
# the chunk of the chunked scan (cfg.ssd_chunk), which every padded
# prompt batch must be a multiple of: the serves' prefill_bucket
SSD_BUCKET = 128
# generate's 4 prompts (several chunks, and a state carried across them)
# and the serves' 8 requests, one past the paged chunk threshold (4 *
# SSD_BUCKET = 512 tokens)
SSD_LENS = [37, 130, 300, 500]
SSD_SERVE_LENS = [37, 130, 300, 500, 64, 600, 200, 90]


def phase_ssd_cross_device(torch, TM, Engine, ServeConfig, Request, cfg) -> dict:
    """21a: 2 layers at full width, packed "precise" from one seed, on the
    CPU (plain versions) and on the card (kernels): generate's sampled
    logits within KV_TIE * max|logit| up to the first differing token,
    and the greedy tokens of generate and a dense serve equal under phase
    9's near-tie rule."""
    print("== phase 21a: mamba2-370m at full width, 2 layers: CPU (plain) vs card (kernels)")
    model = TM.init(cfg.replace(n_layers=2), seed=21, device="cuda", pack="precise")
    scfg = ServeConfig(max_len=256, batch_size=2, prefill_bucket=SSD_BUCKET)
    gpu = Engine(model, scfg, device="cuda")
    cpu = Engine(copy.deepcopy(gpu.model).to("cpu"), scfg, device="cpu")
    toks, lens = _prompts(cfg.vocab_size, [128, 30, 75, 9], seed=21)
    prompts = {r: toks[r, :lens[r]] for r in range(len(lens))}
    t0 = time.perf_counter()
    tapes = []
    outs = []
    for eng in (cpu, gpu):
        tape = SampleTape(eng, cfg.vocab_size)
        outs.append(eng.generate(toks, 10, lengths=lens))
        tapes.append(tape.close())
    cpu_s = time.perf_counter() - t0
    worst = 0.0
    for (lc, tc), (lg, tg) in zip(*tapes):
        top = float(lc.abs().max())
        worst = max(worst, float((lc - lg).abs().max()) / top)
        if worst > KV_TIE:
            raise AssertionError(f"CPU vs card generate logits differ by {worst} of max|logit|")
        if not torch.equal(tc, tg):
            break  # later steps decode other tokens
    ties = check_streams(torch, dict(enumerate(outs[0])), dict(enumerate(outs[1])), prompts,
                         cpu, gpu)
    reqs = [Request(uid=i, tokens=prompts[i], max_new_tokens=6) for i in range(len(lens))]
    s_cpu, s_gpu = cpu.serve(reqs), gpu.serve(reqs)
    ties += check_streams(torch, s_cpu, s_gpu, prompts, cpu, gpu)
    print(f"  generate (lens {lens.tolist()}, 10 new tokens) and serve (4 requests, 2 slots): "
          f"logits within {worst:.4f} of max|logit| (limit {KV_TIE}), CPU vs card tokens "
          f"equal, {len(ties)} near ties taken: {outs[1].tolist()}")
    del cpu, gpu, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"max_rel_logit_diff": worst, "ties": len(ties), "generate_s": cpu_s}


def phase_ssd(torch, TM, Engine, ServeConfig, Request, TO, kernels, cfg) -> dict:
    """21: mamba2-370m at full width and depth (48 layers), seeded,
    packed "precise" as it is drawn, f32, max_len 1024, prefill_bucket
    128: generate, a dense serve, kv8, paged, matched batches and spec_k 3
    at draft bits 7."""
    print("== phase 21: mamba2-370m at full width and depth, packed 'precise': generate, "
          "serve, kv8, paged, speculation")
    import numpy as np

    from repro_torch.serve.engine import _nbytes

    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):  # seconds per part of the phase, for its time budget
        torch.cuda.synchronize()
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 2)
        t_lap[0] = now

    model = TM.init(cfg, seed=0, device="cuda", pack="precise")
    scfg = dict(max_len=1024, batch_size=4, prefill_bucket=SSD_BUCKET)
    eng = Engine(model, ServeConfig(**scfg), device="cuda")
    if eng.pack_report is not None or eng.cfg.quant_method != "dsbp_fused":
        raise AssertionError("the engine repacked a packed model")
    model, n = eng.model, cfg.n_layers
    packed = _nbytes(model)
    embed = 4 * cfg.padded_vocab_size * cfg.d_model
    print(f"  init(pack=): {packed / 1e9:.3f} GB (the tied f32 embedding {embed / 1e9:.3f} GB "
          f"of it), {len(_containers(model))} packed projections")
    toks, lens = _prompts(cfg.vocab_size, SSD_LENS, seed=211)
    width = -(-toks.shape[1] // SSD_BUCKET) * SSD_BUCKET  # generate takes its width as given
    toks = np.pad(toks, ((0, 0), (0, width - toks.shape[1])))
    reqs = _moe_requests(Request, cfg.vocab_size, SSD_SERVE_LENS, 16, seed=212)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lap("init(pack=)")

    # ---- the SSD path: counts from 0 over exactly these runs ----
    _reset_launches(kernels)
    out = eng.generate(toks, 16, lengths=lens)
    gst = dict(eng.last_stats)
    tape = GuardTape(eng, cfg.vocab_size)
    served = eng.serve(reqs)
    ref_rows = tape.close()
    sst = dict(eng.last_stats)
    kv8 = Engine(model, ServeConfig(kv_quant="kv8", **scfg), device="cuda")
    served8 = kv8.serve(reqs)
    kst = dict(kv8.last_stats)
    paged = Engine(model, ServeConfig(paged=True, kv_block_size=16, **scfg), device="cuda")
    tape = GuardTape(paged, cfg.vocab_size)
    pout = paged.serve(reqs)
    prows = tape.close()
    pst = dict(paged.last_stats)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    lap("generate, serve, kv8, paged")
    if launches["dsbp_fused"] <= 0:
        raise AssertionError("B1 was not launched on the SSD path")
    attn = {k: v for k, v in launches.items() if k != "dsbp_fused" and v}
    if attn:
        raise AssertionError(f"attention kernels launched on the attention-free model: {attn}")
    if out.shape != (4, 16) or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"generate output {out.shape} out of range")
    for label, o in (("serve", served), ("kv8 serve", served8), ("paged serve", pout)):
        if sorted(o) != list(range(8)) or any(len(t) != 16 for t in o.values()):
            raise AssertionError(f"{label} did not return 16 tokens for each of 8 requests")
    for uid, t in served.items():  # nothing to quantize: the float serve's tokens
        if not np.array_equal(served8[uid], t):
            raise AssertionError(f"kv8 request {uid}: {served8[uid]} != float {t}")
    if kst["kv_packed"] or kst["kv_bytes_per_token"] != 0:
        raise AssertionError(f"kv8 stats on a model with no KV layer: {kst}")
    if (pst["kv_blocks"] != 0 or paged._last_alloc is not None or pst["chunked_requests"] != 1
            or pst["stalled_decode_steps"] or not pst["completed"]):
        raise AssertionError(f"paged stats on a model with no KV layer: {pst}")
    # every stream's largest difference first, then the gate
    _, pworst = check_recorded(torch, served, pout, ref_rows, prows, kv_tie=math.inf)
    print(f"  paged vs dense, packed: largest logit difference per request, of max|logit|: "
          f"{ {u: round(w, 4) for u, w in pworst.items()} } (limit SSD_TIE {SSD_TIE})")
    pties, pworst = check_recorded(torch, served, pout, ref_rows, prows, kv_tie=SSD_TIE)

    # ---- launches per step, by (K, N) against the containers ----
    step, b1_shapes, pre = _step_launches(torch, eng, kernels, toks, lens, max_len=1024, TO=TO)
    want = {(k, nn): n for k, nn, _ in SSD_B1}
    if step != {"dsbp_fused": 2 * n} or b1_shapes != want or _b1_shapes(model) != want:
        raise AssertionError(f"launches in one decode step {step}, B1 by (K, N) {b1_shapes}; "
                             f"want B1 {2 * n}: {want} (the containers give "
                             f"{_b1_shapes(model)})")
    lap("launches per step")

    # ---- matched batches (generate's 4 prompts as 4 requests, one group,
    # 4 lanes, no chunk): paged == dense token for token ----
    same = _moe_requests(Request, cfg.vocab_size, SSD_LENS, 16, seed=213)
    mcfg = dict(scfg, chunk_prefill_tokens=1024)
    exact = {pg: Engine(model, ServeConfig(paged=pg, **mcfg), device="cuda").serve(same)
             for pg in (False, True)}
    for uid, t in exact[False].items():
        if not np.array_equal(exact[True][uid], t):
            raise AssertionError(f"matched batches, request {uid}: paged {exact[True][uid]} != "
                                 f"dense {t}")
    lap("matched batches")

    # ---- the chunk path without FP8: the float model's paged serve (the
    # 600-token prompt in chunk steps through the verify path, the other
    # lanes frozen) against its dense serve (the chunked scan over the
    # whole prompt) within RING_REL, at SSD_FLOAT_LAYERS layers; two
    # planted faults in the chunk steps' commit must fail it ----
    from repro_torch.models import blocks as TB

    fmodel = TM.init(cfg.replace(quant=None, n_layers=SSD_FLOAT_LAYERS), seed=0, device="cuda")
    fdense = Engine(fmodel, ServeConfig(**scfg), device="cuda")
    tape = GuardTape(fdense, cfg.vocab_size)
    fserved = fdense.serve(reqs)
    frows = tape.close()

    def fpaged():
        e = Engine(fmodel, ServeConfig(paged=True, kv_block_size=16, **scfg), device="cuda")
        tape = GuardTape(e, cfg.vocab_size)
        o = e.serve(reqs)
        return o, tape.close(), e.last_stats["chunk_steps"]

    fout, fprows, fchunks = fpaged()
    fties, fworst = check_recorded(torch, fserved, fout, frows, fprows, kv_tie=RING_REL)
    select, planted = TB.select_state_step, {}
    for label, fault in (
            ("a chunk commits keep - 1 tokens",
             lambda st, keep, old=None: select(st, (keep - 1).clamp(min=0), old)),
            ("the frozen lanes take the chunk's first step",
             lambda st, keep, old=None: select(st, keep))):
        TB.select_state_step = fault
        try:
            o, rows, _ = fpaged()
        finally:
            TB.select_state_step = select
        try:
            check_recorded(torch, fserved, o, frows, rows, kv_tie=RING_REL)
        except AssertionError as err:
            planted[label] = str(err)[:160]
        else:
            raise AssertionError(f"a planted fault ({label}) passes the float paged check at "
                                 f"{RING_REL}")
    del fdense, fmodel
    torch.cuda.empty_cache()
    print(f"  float model at {SSD_FLOAT_LAYERS} layers, paged ({fchunks} chunk steps) vs dense: "
          f"largest logit difference "
          f"{max(fworst.values()):.2e} of max|logit| (limit RING_REL {RING_REL}), "
          f"{len(fties)} near ties; planted faults fail it: {planted}")
    lap("float paged vs dense, planted faults")

    # ---- speculation (spec_k 3, draft bits 7) against spec_k 0 ----
    spec = _spec_serve(torch, Engine, ServeConfig, TO, kernels, model, cfg, reqs, served,
                       ref_rows, dict(scfg, spec_draft_bits=7),
                       "spec_k 3, draft bits 7, dense, packed", b1_per_step=2 * n,
                       attn_layers=0, kv_tie=SSD_TIE)
    lap("speculation")
    trace = trace_decode(torch, eng, toks, lens, TRACE_SSD, steps=2, max_len=1024)
    lap("trace")
    ms_step = 1e3 * gst["decode_s"] / gst["decode_steps"]
    serve_ms = 1e3 * sst["decode_time_s"] / sst["decode_steps"]
    paged_ms = 1e3 * pst["decode_time_s"] / pst["decode_steps"]
    state_bytes = 4 * n * cfg.n_ssd_heads * cfg.ssm_headdim * cfg.ssm_state  # per lane
    print(f"  generate: 4 prompts (lens {lens.tolist()}, padded to {width}), 16 new tokens: "
          f"prefill {gst['prefill_s']:.3f} s, {ms_step:.2f} ms per decode step")
    print(f"  serve: 8 requests (lens {SSD_SERVE_LENS}) through 4 slots: {sst['decode_steps']} "
          f"steps, prefill {sst['prefill_time_s']:.3f} s, {serve_ms:.2f} ms/step; kv8 the same "
          f"tokens, {1e3 * kst['decode_time_s'] / kst['decode_steps']:.2f} ms/step; paged (no "
          f"pool: kv_blocks 0; {pst['chunk_steps']} chunk steps for the {SSD_SERVE_LENS[5]}-token "
          f"prompt) {paged_ms:.2f} ms/step, held to the dense serve under phase 9's rule at "
          f"SSD_TIE ({len(pties)} near ties, largest logit difference "
          f"{max(pworst.values()):.4f} of max|logit|); matched batches paged == dense token "
          f"for token")
    print(f"  peak memory {peak / 2**30:.2f} GiB over generate, serve, kv8 and paged "
          f"(max_memory_allocated; the state: {state_bytes / 2**20:.0f} MiB per lane)")
    print(f"  launches over that run: {launches}; per decode step B1 {2 * n} by (K, N) "
          f"{b1_shapes}; per prefill {pre}")
    res = {"packed_bytes": packed, "launches": launches, "step_launches": step,
           "b1_by_shape": {f"K={k} N={nn}": c for (k, nn), c in b1_shapes.items()},
           "prefill_launches": pre, "prefill_s": gst["prefill_s"], "decode_ms": ms_step,
           "serve_ms": serve_ms, "serve_prefill_s": sst["prefill_time_s"],
           "kv8_ms": 1e3 * kst["decode_time_s"] / kst["decode_steps"], "paged_ms": paged_ms,
           "paged_chunk_steps": pst["chunk_steps"], "paged_prefill_s": pst["prefill_time_s"],
           "paged_ties": len(pties), "paged_worst": pworst,
           "float_paged_worst": max(fworst.values()), "float_paged_ties": len(fties),
           "planted_faults": planted, "peak": peak,
           "state_bytes_per_lane": state_bytes, "trace": trace,
           "spec": {"accepted_hist": spec["stats"]["accepted_hist"],
                    "mean_accepted": spec["stats"]["mean_accepted"],
                    "ms_round": spec["ms_round"], "ms_token": spec["ms_token"],
                    "ties": spec["ties"], "worst": spec["worst"], "peak": spec["peak"]},
           "seconds_by_part": laps}
    print(f"  seconds by part: {laps}")
    del eng, kv8, paged, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def ssd_kernels(torch, Q, DF, per_tensor_scale) -> list:
    print("== phase 21 (kernels): B1 at mamba2-370m's shapes, decode and prefill (M=2048: "
          "w_in's partial prefill column tile)")
    gen = torch.Generator(device="cuda").manual_seed(21)
    b1 = [{**b1_case(torch, Q, DF, per_tensor_scale, gen, m, k, n), "proj": proj}
          for k, n, proj in SSD_B1 for m in (4, 2048)]
    torch.cuda.empty_cache()
    return b1


def ssd_phases(torch, TM, Engine, ServeConfig, Request, Q, DF, FA, TO, per_tensor_scale,
               get_config, card: str, b1=None) -> dict:
    """Phase 21 whole: B1 at mamba2-370m's shapes (``b1``, where they were
    timed already), 21a and 21; returns their records (one ``ssd (phase
    21):`` JSON line printed)."""
    kernels = {"dsbp_fused": DF.dsbp_fused, "flash_attention": FA.flash_attention,
               "packed_flash_attention": FA.packed_flash_attention,
               "paged_flash_attention": FA.paged_flash_attention,
               "paged_packed_flash_attention": FA.paged_packed_flash_attention}
    t0 = time.perf_counter()
    if b1 is None:
        b1 = ssd_kernels(torch, Q, DF, per_tensor_scale)
    cfg = get_config("mamba2-370m").replace(quant="precise")
    cross = phase_ssd_cross_device(torch, TM, Engine, ServeConfig, Request, cfg)
    main = phase_ssd(torch, TM, Engine, ServeConfig, Request, TO, kernels, cfg)
    for x in b1:
        if x["M"] == 4:
            x["launches_per_step"] = main["b1_by_shape"][f"K={x['K']} N={x['N']}"]
            x["launches_of"] = "one decode step, phase 21, 48 layers"
    rec = {"card": card, "b1": b1, "21a": cross, "21": main,
           "seconds": time.perf_counter() - t0}
    print(f"  phase 21: {rec['seconds']:.1f} s")
    print("ssd (phase 21): " + json.dumps(rec, default=str))
    return rec


# ---------------------------------------------------------------------------
# phase 22: the modality frontends over the dense stack: musicgen-large
# (audio codebooks: (B, L, 4) prompts, 4 heads of 2,048) and llava-next-34b
# (2,880 image-patch embeddings prepended, GQA 56 : 8), at full width and
# depth, through Engine.generate (serve refuses both, as the reference)
# ---------------------------------------------------------------------------



def frontend_b1(cfg) -> list:
    """B1's (K, N, projections) in a decode step of a dense layer of
    ``cfg``: musicgen-large's MHA gives (2048, 2048) wq wk wv wo, (2048,
    8192) w1 w3, (8192, 2048) w2; llava-next-34b's GQA (7168, 7168) wq wo,
    (7168, 1024) wk wv, (7168, 20480) w1 w3, (20480, 7168) w2."""
    d, dq, dkv, ff = (cfg.d_model, cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head,
                      cfg.d_ff)
    shapes: dict = {}
    for name, kn in (("wq", (d, dq)), ("wk", (d, dkv)), ("wv", (d, dkv)), ("wo", (dq, d)),
                     ("w1", (d, ff)), ("w3", (d, ff)), ("w2", (ff, d))):
        shapes.setdefault(kn, []).append(name)
    return [(k, n, " ".join(names)) for (k, n), names in shapes.items()]

# musicgen's 4 prompts of phase 5's lengths (frames), 16 new frames
MUSICGEN_LENS = [16, 48, 96, 128]
MUSICGEN_MAX_LEN = 160
# llava's 2 rows: the full image prefix of the config plus 32 / 128 text
# tokens, 8 new tokens, max_len 3,072
LLAVA_TEXT = [32, 128]
LLAVA_MAX_LEN = 3072
LLAVA_NEW = 8
# 22a's cuts: the CPU side runs the plain versions, and plain B1 over
# ~6,000 rows x d_ff 20,480 on the host would not fit the time limit; its
# ragged prompts are short (the plain version converts every packed weight
# to float64 per call, ~1.2 GB at llava's w1) and it generates 6 tokens
FRONTEND_CROSS = {"musicgen-large": dict(n_layers=2),
                  "llava-next-34b": dict(n_layers=1, n_image_tokens=128)}
FRONTEND_CROSS_LENS = {"musicgen-large": [8, 16, 24, 32], "llava-next-34b": [8, 16]}
FRONTEND_CROSS_NEW = 6
# the plain B1's row blocks at llava's prefill M (its float64 group dots)
PLAIN_ROWS = 256
TRACE_FRONTEND = {"B1": TRACE_FUSED["B1"], "B2": TRACE_FUSED["B2"],
                  "cuBLAS (head)": ("gemv", "gemm", "xmma", "cutlass")}


def frontend_inputs(cfg, lens, seed):
    """Right-padded prompts of ``lens`` ((B, W) text, (B, W, K) codebook
    frames) and ``extra``: seeded standard-normal image embeddings (B,
    S_img, d) for a vlm config (as the reference's tests draw them), else
    None."""
    import numpy as np

    rng = np.random.default_rng(seed)
    k = (cfg.n_codebooks,) if cfg.frontend == "audio_codebooks" else ()
    toks = np.zeros((len(lens), max(lens)) + k, np.int64)
    for j, n in enumerate(lens):
        toks[j, :n] = rng.integers(0, cfg.vocab_size, (n,) + k)
    extra = None
    if cfg.frontend == "vlm_patches":
        extra = {"image_embeds": rng.standard_normal(
            (len(lens), cfg.n_image_tokens, cfg.d_model)).astype(np.float32)}
    return toks, np.asarray(lens, np.int32), extra


def codebook_calls(calls, cfg):
    """A :class:`SampleTape`'s batches as one row per (sequence, codebook):
    (B, K * Vp) logits -> (B * K, V), (B, K) tokens -> (B * K,), so phase
    9's rule holds each codebook on its own (a text model's as they are)."""
    if cfg.frontend != "audio_codebooks":
        return [(lg[:, :cfg.vocab_size], tok) for lg, tok in calls]
    vp = cfg.padded_vocab_size
    return [(lg.reshape(-1, vp)[:, :cfg.vocab_size], tok.reshape(-1)) for lg, tok in calls]


class StepCounter:
    """Each kernel's launches in every decode step of an engine's runs,
    and B1's by its weight's (K, N): the wrappers' host counters read
    around ``Model.decode_step`` (no sync), so the timed run itself is
    counted.  What a run launched outside its decode steps is its
    prefill's."""

    def __init__(self, eng, kernels, TO):
        self.steps, self.shapes, self.cache = [], collections.Counter(), None
        self._eng, self._TO, self._b1 = eng, TO, TO.dsbp_fused
        b1, shapes, step = TO.dsbp_fused, self.shapes, eng.model.decode_step

        def count(x, ts, ka, *rest):
            shapes[tuple(ka.shape)] += 1
            return b1(x, ts, ka, *rest)

        def counted(*args, **kw):
            before, seen = {k: fn.launches for k, fn in kernels.items()}, dict(shapes)
            self.cache = args[1]  # the run's cache, for a trace that goes on from it
            out = step(*args, **kw)
            self.steps.append(({k: fn.launches - before[k] for k, fn in kernels.items()
                                if fn.launches != before[k]},
                               {kn: c - seen.get(kn, 0) for kn, c in shapes.items()
                                if c != seen.get(kn, 0)}))
            return out

        TO.dsbp_fused = count
        eng.model.decode_step = counted

    def close(self):
        """(the decode steps' counts, B1's launches by (K, N) over the
        whole run, the run's cache after its last step)."""
        self._TO.dsbp_fused = self._b1
        del self._eng.model.decode_step
        return self.steps, dict(self.shapes), self.cache


def _per_step(steps, label: str):
    """The one launch count every decode step of a run shares."""
    if not steps or any(s != steps[0] for s in steps):
        raise AssertionError(f"{label}: decode steps launched {steps}")
    return steps[0]


def phase_frontend_kernels(torch, Q, DF, FA, KVQ, per_tensor_scale, cfgs) -> dict:
    """B1 at every new decode shape (musicgen's M 4, llava's M 2) and at
    llava's prefill M (2 rows x 3,008 positions), bit-equal to plain; B2 at
    musicgen's MHA D 64 and llava's GQA 56 : 8 at D 128 over its ~3,000-
    position prompt, prefill and decode, within 1e-5 of plain; B5 at both
    decode shapes over the same K/V quantized to kv8, bit-equal to B2 over
    its dequantized view and within 1e-5 of plain; timed cold with their
    plain versions, SDPA and their bounds."""
    print("== phase 22 (kernels): B1, B2 and B5 at musicgen-large's and llava-next-34b's "
          "shapes")
    gen = torch.Generator(device="cuda").manual_seed(22)
    mg, lv = cfgs["musicgen-large"], cfgs["llava-next-34b"]
    width = max(LLAVA_TEXT) + lv.n_image_tokens
    b1 = []
    for arch, m, plain_rows in (("musicgen-large", len(MUSICGEN_LENS), None),
                                ("llava-next-34b", len(LLAVA_TEXT), None),
                                ("llava-next-34b", len(LLAVA_TEXT) * width, PLAIN_ROWS)):
        for k, n, proj in frontend_b1(cfgs[arch]):
            b1.append({**b1_case(torch, Q, DF, per_tensor_scale, gen, m, k, n,
                                 plain_rows=plain_rows), "arch": arch, "proj": proj})
            torch.cuda.empty_cache()
    b2, b5 = {}, {}
    for arch, c, lens, s_dec, new in (
            ("musicgen-large", mg, MUSICGEN_LENS, MUSICGEN_MAX_LEN, 16),
            ("llava-next-34b", lv, [t + lv.n_image_tokens for t in LLAVA_TEXT], LLAVA_MAX_LEN,
             LLAVA_NEW)):
        hq, hkv, d = c.n_heads, c.n_kv_heads, c.d_head
        b, s = len(lens), max(lens)
        q = torch.randn(b, hq, s, d, generator=gen, device="cuda")
        k = torch.randn(b, hkv, s_dec, d, generator=gen, device="cuda")
        v = torch.randn(b, hkv, s_dec, d, generator=gen, device="cuda")
        b2[f"{arch} prefill"] = b2_case(torch, FA, f"{arch} prefill", q, k[:, :, :s].contiguous(),
                                        v[:, :, :s].contiguous(), lens, [0] * b)
        last = [n + new - 1 for n in lens]  # the last decode step's positions
        b2[f"{arch} decode"] = b2_case(torch, FA, f"{arch} decode", q[:, :, :1].contiguous(),
                                       k, v, [p + 1 for p in last], last)
        kv8 = KVQ.KV_PRESETS["kv8"]  # the kv8 run's decode attention
        b5[f"{arch} decode"] = b5_case(torch, FA, f"{arch} decode", q[:, :, :1].contiguous(),
                                       KVQ.quantize_kv(k, kv8), KVQ.quantize_kv(v, kv8),
                                       [p + 1 for p in last], last)
        del q, k, v
        torch.cuda.empty_cache()
    return {"b1": b1, "b2": b2, "b5": b5}


def phase_frontend_cross_device(torch, TM, Engine, ServeConfig, cfgs) -> dict:
    """22a: each frontend at full width, cut in depth (FRONTEND_CROSS;
    llava's image prefix to 128 tokens), float and packed "precise" from
    one seed, on the CPU (plain versions) and on the card (kernels): a
    ragged generate's sampled logits and tokens under phase 9's rule, per
    codebook; the float model also over a kv8 cache (B5 at the frontends'
    head layouts, D 64 MHA and GQA 56 : 8, where float weights keep the
    two devices' logits within ~1e-5 of max|logit|)."""
    out = {}
    for arch, cfg in cfgs.items():
        cut = FRONTEND_CROSS[arch]
        print(f"== phase 22a: {arch} at full width, {cut} (reduced): CPU (plain) vs card "
              f"(kernels), float and packed, float also over kv8")
        for packed in (False, True):
            c = cfg.replace(quant="precise" if packed else None, **cut)
            model = TM.init(c, seed=22, device="cuda", pack="precise" if packed else None)
            toks, lens, extra = frontend_inputs(c, FRONTEND_CROSS_LENS[arch], seed=22)
            scfg = ServeConfig(max_len=max(lens) + c.n_image_tokens + 16, batch_size=len(lens))
            gpu = Engine(model, scfg, device="cuda")
            cpu = Engine(copy.deepcopy(gpu.model).to("cpu"), scfg, device="cpu")
            for kv in (None,) if packed else (None, "kv8"):
                engs = [e if kv is None else
                        Engine(e.model, dataclasses.replace(scfg, kv_quant=kv), device=dev)
                        for e, dev in ((cpu, "cpu"), (gpu, "cuda"))]
                t0 = time.perf_counter()
                tapes, outs = [], []
                for eng in engs:
                    tape = SampleTape(eng, 10**9)  # every column: codebook_calls cuts them
                    outs.append(eng.generate(toks, FRONTEND_CROSS_NEW, extra=extra,
                                             lengths=lens))
                    tapes.append(codebook_calls(tape.close(), c))
                at, equal, worst = check_calls(torch, *tapes)
                label = ("packed" if packed else "float") + (f", {kv}" if kv else "")
                shape = (len(lens), FRONTEND_CROSS_NEW) + ((c.n_codebooks,) if c.n_codebooks
                                                            else ())
                if outs[1].shape != shape:
                    raise AssertionError(f"{arch} {label}: generate gave {outs[1].shape}, "
                                         f"want {shape}")
                print(f"  {label}: generate (lens {lens.tolist()}"
                      + (f" + {c.n_image_tokens} image tokens" if extra else "")
                      + f", {FRONTEND_CROSS_NEW} new): {len(tapes[0])} sampled batches of "
                      f"{tapes[0][0][0].shape[0]} rows (sequence x codebook), logits within "
                      f"{worst:.2e} of max|logit| (limit {KV_TIE}), {equal} batches "
                      f"bit-equal, "
                      + ("every token equal" if at is None else f"near tie at batch {at}")
                      + f"; {time.perf_counter() - t0:.1f} s")
                out[f"{arch} {label}"] = {"max_rel_logit_diff": worst, "equal_batches": equal,
                                          "near_tie_batch": at, "cut": cut}
                del engs
            del gpu, cpu, model
            gc.collect()
            torch.cuda.empty_cache()
    return out


def _frontend_generate(torch, Engine, ServeConfig, TO, kernels, model, cfg, scfg, toks, lens,
                       extra, new, kv=None):
    """One counted ``generate`` through an engine over ``model``: the
    output, its stats, the sampled logits (the tape) and the launches of
    each decode step."""
    eng = Engine(model, ServeConfig(kv_quant=kv, **scfg), device="cuda")
    counter = StepCounter(eng, kernels, TO)
    tape = SampleTape(eng, 10**9)
    try:
        out = eng.generate(toks, new, extra=extra, lengths=lens)
    finally:
        calls = tape.close()
        steps, b1_all, cache = counter.close()
    return (eng, out, dict(eng.last_stats), codebook_calls(calls, cfg), steps, b1_all,
            (torch.as_tensor(calls[-1][1], device="cuda")[:, None], cache))


def _check_frontend_run(torch, cfg, out, calls, shape, label):
    import numpy as np

    if out.shape != shape or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"{label}: generate output {out.shape} (want {shape}) or its "
                             f"range is wrong")
    for lg, tok in calls:
        if not torch.isfinite(lg).all() or not torch.equal(lg.argmax(-1), tok):
            raise AssertionError(f"{label}: sampled logits not finite or not the greedy ones")
    for i, (_, tok) in enumerate(calls):
        if not np.array_equal(tok.numpy().reshape(out.shape[0], -1),
                              out[:, i].reshape(out.shape[0], -1)):
            raise AssertionError(f"{label}: the tape's tokens are not the output")


def pack_transient(torch, cfg) -> tuple:
    """The bytes ``pack_weights`` holds on the card above its input and its
    output while it packs a random matrix of ``cfg``'s widest projection
    (the largest K * N of a layer): ``dsbp_quantize``'s full-size
    temporaries.  Returns (bytes, (K, N))."""
    from repro_torch.core.quantized import pack_weights
    from repro_torch.serve.engine import _nbytes

    k, n, _ = max(frontend_b1(cfg), key=lambda x: x[0] * x[1])
    w = torch.randn(k, n, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pw = pack_weights(w, "precise")
    torch.cuda.synchronize()
    held = torch.cuda.max_memory_allocated() - base - _nbytes(pw)
    del w, pw
    torch.cuda.empty_cache()
    return held, (k, n)


# small allocations the init-peak gate leaves room for (norms, a layer's
# scalars), beside the packed model, one f32 layer and the pack's transient
INIT_SLACK = 16 * 2**20


def packed_init(torch, TM, cfg, lap) -> tuple:
    """``cfg`` drawn from seed 0 and packed "precise" one layer at a time
    by init(pack=), on the card, its peak gated: the packed model, the
    layer being packed in f32 and pack_weights' temporaries of its widest
    matrix, measured alone first (dsbp_quantize's full-size fields and
    their grouped copies), + INIT_SLACK.  Returns (model, record)."""
    from repro_torch.serve.engine import _nbytes

    transient, (tk, tn) = pack_transient(torch, cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = TM.init(cfg, seed=0, device="cuda", pack="precise")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    lap("init(pack=)")
    packed = _nbytes(model)
    layer_f32 = 4 * sum(p.numel() for p in TM.Model(cfg.replace(n_layers=1), "meta")
                        .layers[0].parameters())
    init_limit = packed + layer_f32 + transient + INIT_SLACK
    print(f"  init(pack=) {seconds:.2f} s: {packed / 1e9:.2f} GB packed (the f32 embedding and head "
          f"{8 * TM._vocab_rows(cfg) * cfg.d_model / 1e9:.2f} GB of it); peak "
          f"{init_peak / 1e9:.2f} GB = packed + {(init_peak - packed) / 1e9:.2f} GB; limit "
          f"{init_limit / 1e9:.2f} GB = packed + one f32 layer {layer_f32 / 1e9:.2f} GB + the "
          f"pack's transient at K={tk} N={tn} {transient / 1e9:.2f} GB "
          f"({transient / (4 * tk * tn):.2f}x the matrix's f32 bytes) + "
          f"{INIT_SLACK // 2**20} MiB")
    if init_peak > init_limit:
        raise AssertionError(f"{cfg.name}: init(pack=) peaked at {init_peak / 1e9:.2f} GB: more "
                             f"than the packed model, one f32 layer and the pack's transient "
                             f"({init_limit / 1e9:.2f} GB)")
    return model, {"init_peak": init_peak, "init_limit": init_limit,
                   "pack_transient": {"bytes": transient, "K": tk, "N": tn},
                   "packed_bytes": packed, "layer_f32_bytes": layer_f32}


def runs_peak_limit(cfg, init: dict, b: int, max_len: int, width: int) -> tuple:
    """The peak a model's runs may reach: packed + two f32 layers + a KV
    cache of ``b`` rows x ``max_len`` + the prefill's K/V and activations
    over ``width`` positions.  Returns (limit, the cache's bytes)."""
    n = cfg.n_layers
    cache = 2 * n * b * cfg.n_kv_heads * max_len * cfg.d_head * 4
    prompt_kv = 2 * n * b * cfg.n_kv_heads * width * cfg.d_head * 4
    acts = 6 * b * width * cfg.d_ff * 4
    return init["packed_bytes"] + 2 * init["layer_f32_bytes"] + cache + prompt_kv + acts, cache


def phase_frontend(torch, TM, Engine, ServeConfig, TO, kernels, cfg, label: str) -> dict:
    """22 (musicgen-large) / 22b (llava-next-34b): full width and depth,
    drawn and packed one layer at a time ("precise"), f32: a ragged
    ``generate`` over a float cache, then over kv8, each kernel's launches
    counted in every decode step, prefill s, ms per step, peak memory;
    llava also a 2-step trace."""
    audio = cfg.frontend == "audio_codebooks"
    print(f"== phase {label}: {cfg.name} at full width and depth ({cfg.n_layers} layers, "
          f"~{cfg.param_count() / 1e9:.2f}e9 parameters), init(pack=): generate, float KV "
          f"then kv8")
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):  # seconds per part of the phase, for its time budget
        torch.cuda.synchronize()
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 2)
        t_lap[0] = now

    # drawn and packed one layer at a time (llava-next-34b is ~134 GB in f32)
    model, init = packed_init(torch, TM, cfg, lap)
    if audio:
        toks, lens, extra = frontend_inputs(cfg, MUSICGEN_LENS, seed=221)
        new, max_len, api_lens = 16, MUSICGEN_MAX_LEN, lens
    else:
        toks, lens, extra = frontend_inputs(cfg, LLAVA_TEXT, seed=222)
        new, max_len, api_lens = LLAVA_NEW, LLAVA_MAX_LEN, lens
        lens = lens + cfg.n_image_tokens  # the model's lengths count the image prefix
    b, n = len(lens), cfg.n_layers
    width = toks.shape[1] + cfg.n_image_tokens
    scfg = dict(max_len=max_len, batch_size=b)
    shape = (b, new) + ((cfg.n_codebooks,) if audio else ())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lap("inputs")

    # ---- the frontend path: counts from 0 over exactly these two runs ----
    runs, launches, trace = {}, collections.Counter(), None
    for kv in (None, "kv8"):
        _reset_launches(kernels)
        eng, out, st, calls, steps, b1_all, (tok, cache) = _frontend_generate(
            torch, Engine, ServeConfig, TO, kernels, model, cfg, scfg, toks, api_lens, extra,
            new, kv)
        if eng.pack_report is not None or eng.cfg.quant_method != "dsbp_fused":
            raise AssertionError("the engine repacked a packed model")
        runs[kv or "float"] = dict(out=out, st=st, calls=calls, steps=steps, b1_all=b1_all)
        launches.update({k: fn.launches for k, fn in kernels.items()})
        lap(f"generate, {kv or 'float'} KV")
        if kv is None and not audio:  # two more decode steps of the run, from its cache
            pos = torch.as_tensor(lens + new - 1, dtype=torch.int32, device="cuda")
            trace = trace_decode(torch, eng, None, None, TRACE_FRONTEND, steps=2,
                                 start=(tok.reshape(b, 1), cache, pos))
            lap("trace")
        del eng, tok, cache
    torch.cuda.synchronize()
    launches = dict(launches)
    peak = torch.cuda.max_memory_allocated()
    for name in ("dsbp_fused", "flash_attention", "packed_flash_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {cfg.name} path")

    # ---- gates: output, launches per decode step by (K, N), memory ----
    want_b1 = {(k, nn): n * len(proj.split()) for k, nn, proj in frontend_b1(cfg)}
    per_step = {}
    for kv, attn in (("float", "flash_attention"), ("kv8", "packed_flash_attention")):
        r = runs[kv]
        _check_frontend_run(torch, cfg, r["out"], r["calls"], shape, f"{cfg.name} {kv} KV")
        step = _per_step([c for c, _ in r["steps"]], f"{cfg.name} {kv}")
        shapes = _per_step([sh for _, sh in r["steps"]], f"{cfg.name} {kv} B1 by (K, N)")
        want = {"dsbp_fused": sum(want_b1.values()), attn: n}
        if step != want or shapes != want_b1 or _b1_shapes(model) != want_b1:
            raise AssertionError(f"{cfg.name} {kv}: one decode step launched {step}, B1 by "
                                 f"(K, N) {shapes}; want {want}, {want_b1} (the containers "
                                 f"give {_b1_shapes(model)})")
        per_step[kv] = {"launches": step, "b1_by_shape": shapes,
                        "prefill_b1_by_shape": {kn: c - (new - 1) * shapes.get(kn, 0)
                                                for kn, c in r["b1_all"].items()}}
    # the dense prefill attends float K/V under kv8 too: the first sampled
    # batch is the float run's, bit for bit
    first_f, first_8 = runs["float"]["calls"][0], runs["kv8"]["calls"][0]
    if not (torch.equal(first_f[0], first_8[0]) and torch.equal(first_f[1], first_8[1])):
        raise AssertionError(f"{cfg.name}: the kv8 run's first sampled batch differs from the "
                             f"float run's")
    kv8_worst, kv8_same = 0.0, 0  # printed: kv8 rounds K/V, the float cache does not
    for (a, ta), (c, tc) in zip(runs["float"]["calls"], runs["kv8"]["calls"]):
        kv8_worst = max(kv8_worst, float((a - c).abs().max() / a.abs().max()))
        if not torch.equal(ta, tc):
            break
        kv8_same += 1
    limit, cache = runs_peak_limit(cfg, init, b, max_len, width)
    if peak > limit:
        raise AssertionError(f"{cfg.name}: peak {peak / 1e9:.2f} GB above packed + two f32 "
                             f"layers + the cache + the prefill's K/V and activations "
                             f"({limit / 1e9:.2f} GB)")
    lap("gates")
    res = {"params": cfg.param_count(), "init_s": laps["init(pack=)"], **init,
           "launches": launches,
           "peak": peak, "peak_limit": limit, "trace": trace, "seconds_by_part": laps,
           "kv8_vs_float": {"max_rel_logit_diff": kv8_worst, "equal_batches": kv8_same}}
    for kv, r in runs.items():
        st = r["st"]
        res[kv] = {"prefill_s": st["prefill_s"],
                   "decode_ms": 1e3 * st["decode_s"] / st["decode_steps"],
                   "step_launches": per_step[kv]["launches"],
                   "b1_by_shape": {f"K={k} N={nn}": c
                                   for (k, nn), c in per_step[kv]["b1_by_shape"].items()},
                   "prefill_b1_by_shape": {f"K={k} N={nn}": c for (k, nn), c in
                                           per_step[kv]["prefill_b1_by_shape"].items()}}
        print(f"  generate, {kv} KV: {b} prompts (lens {api_lens.tolist()}"
              + (f" + {cfg.n_image_tokens} image tokens each" if extra else " frames")
              + f"), {new} new: prefill {st['prefill_s']:.3f} s, {res[kv]['decode_ms']:.2f} ms "
              f"per decode step; per step {per_step[kv]['launches']}, B1 by (K, N) "
              f"{per_step[kv]['b1_by_shape']}; output {r['out'].shape}: "
              f"{r['out'][0, :4].tolist()}")
    print(f"  peak memory {peak / 2**30:.2f} GiB over both runs and the trace (limit "
          f"{limit / 2**30:.2f} GiB: packed + two f32 layers + the {cache / 1e9:.2f} GB "
          f"cache + the prefill's K/V and activations); launches {launches}; kv8's first "
          f"sampled batch bit-equal to float's, its tokens equal over {kv8_same} of {new} "
          f"batches, logits up to there within {kv8_worst:.4f} of max|logit| (printed, not "
          f"gated)")
    print(f"  seconds by part: {laps}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def frontend_configs(get_config) -> dict:
    return {arch: get_config(arch).replace(quant="precise")
            for arch in ("musicgen-large", "llava-next-34b")}


def frontend_phases(torch, TM, Engine, ServeConfig, Q, DF, FA, KVQ, TO, per_tensor_scale,
                    get_config, card: str, rows=None) -> dict:
    """Phase 22 whole: the kernels at the frontends' shapes (``rows``, where
    they were timed already), 22a, 22 (musicgen-large) and 22b
    (llava-next-34b); returns their records (one ``frontends (phase 22):``
    JSON line printed)."""
    kernels = {"dsbp_fused": DF.dsbp_fused, "flash_attention": FA.flash_attention,
               "packed_flash_attention": FA.packed_flash_attention}
    t0 = time.perf_counter()
    cfgs = frontend_configs(get_config)
    if rows is None:
        rows = phase_frontend_kernels(torch, Q, DF, FA, KVQ, per_tensor_scale, cfgs)
    cross = phase_frontend_cross_device(torch, TM, Engine, ServeConfig, cfgs)
    main = {"musicgen-large": phase_frontend(torch, TM, Engine, ServeConfig, TO, kernels,
                                             cfgs["musicgen-large"], "22"),
            "llava-next-34b": phase_frontend(torch, TM, Engine, ServeConfig, TO, kernels,
                                             cfgs["llava-next-34b"], "22b")}
    # B1's rows carry the launches counted per decode step (or per prefill)
    # of the served models, and every shape launched was timed
    for x in rows["b1"]:
        r = main[x["arch"]]["float"]
        key = f"K={x['K']} N={x['N']}"
        if x["M"] <= 4:
            x["launches_per_step"] = r["b1_by_shape"][key]
            x["launches_of"] = f"one decode step, {x['arch']}, full depth"
        else:
            x["launches_per_prefill"] = r["prefill_b1_by_shape"][key]
    for arch, r in main.items():
        timed = {f"K={x['K']} N={x['N']}" for x in rows["b1"] if x["arch"] == arch}
        if timed != set(r["float"]["b1_by_shape"]):
            raise AssertionError(f"{arch}: B1 launched at {sorted(r['float']['b1_by_shape'])}, "
                                 f"timed at {sorted(timed)}")
        rows["b2"][f"{arch} decode"]["launches_per_step"] = \
            r["float"]["step_launches"]["flash_attention"]
        rows["b5"][f"{arch} decode"]["launches_per_step"] = \
            r["kv8"]["step_launches"]["packed_flash_attention"]
    rec = {"card": card, "kernels": rows, "22a": cross, **main,
           "seconds": time.perf_counter() - t0}
    print(f"  phase 22: {rec['seconds']:.1f} s")
    print("frontends (phase 22): " + json.dumps(rec, default=str))
    return rec


# ---------------------------------------------------------------------------
# phase 23: the bfloat16 dtype (parameters, activations and caches in bf16
# around the f32 DSBP GEMM; the attention kernels' bf16 instantiation)
# ---------------------------------------------------------------------------

# the near-tie bound of bf16 logits, in bf16 ulps of max|logit|: exact ties
# and one-ulp near ties are common among bf16 logits, where TIE * max|logit|
# is a tenth of an ulp; two equally valid roundings of a bf16 activation
# (the kernels' q * d**-0.5 in f32, the plain versions' in bf16; a batch's
# per-tensor FP8 scale) move a logit by a few ulps
BF16_TIE_ULPS = 8
# phase 23's paged serve against its dense batch-8 serve (bf16): a
# chunked prompt's last chunk attends through the verify path
# (PyTorch, q * d**-0.5 rounded to bf16 as the JAX model's jnp code) where
# the dense prefill runs B2 (q scaled in f32, as the TPU kernel), and
# every activation rounds to bf16 (2**-9) before the next layer's FP8
# inputs, so two equally valid roundings compound over 32 layers: 0.110
# of max|logit| at a chunked stream's second token at full depth on an
# H100, 0.108 at SPEC_LAYERS (the other streams 0.01; PERF.md, phase 23),
# where f32 stays within KV_TIE.  The strict check stays: paged ==
# dense token for token at matched batches
BF16_KV_TIE = HYBRID_TIE
# 23b's mixtral-8x7b (2 layers, bf16) CPU vs card: bf16 router logits tie
# exactly far more often than f32 ones, and a row whose top-2 routing flips
# swaps a whole expert's output (phase 20b's route flips): 0.353 of
# max|logit| in one row of one batch on an H100 (PERF.md, phase 23),
# the tokens equal; the other families hold KV_TIE
BF16_MOE_TIE = 0.5
# the bf16 kernels against their plain versions (as much of max|out|): the
# plain versions round q * d**-0.5 to bf16 (the JAX model's jnp code), the
# kernels scale the f32 upcast (the TPU kernels'): a relative 2**-9 in q
# moves each logit by up to 2**-9 |logit| and the output rounds once more;
# measured 2**-8 at llama-7b's prefill on an H100 (PERF.md, phase 23)
BF16_PLAIN_REL = 2 ** -6
# (name, Hq, Hkv, D) of the bf16 kernel cases: llama-7b's MHA and
# recurrentgemma-2b's MQA at d_head 256
BF16_HEADS = {"llama-7b": (32, 32, 128), "recurrentgemma-2b": (10, 1, 256)}
# the depth of 23b's CPU-vs-card models (full width): phase 22a's cuts, and
# recurrentgemma-2b at 3 layers so its attn_local layer (MQA, D 256) is in
BF16_FAMILIES = {"recurrentgemma-2b": dict(n_layers=3, window=64),
                 "mixtral-8x7b": dict(n_layers=2), "mamba2-370m": dict(n_layers=2),
                 "musicgen-large": dict(n_layers=2),
                 "llava-next-34b": dict(n_layers=1, n_image_tokens=128)}
BF16_FAMILY_LENS = {"musicgen-large": [8, 16, 24, 32], "llava-next-34b": [8, 16]}
BF16_FAMILY_NEW = 4


def bf16_kernel_case(torch, FA, KVQ, kname: str, label: str, args16: tuple, dense: dict) -> dict:
    """One attention kernel on bf16 operands ``args16`` (q, and float K/V or
    pools, bf16; int8 mantissas and f32 scales for B5 / B7): equal to the
    same kernel's f32 instantiation on the exact upcasts, its output
    rounded once, bit for bit; within BF16_PLAIN_REL of its plain version;
    timed cold beside the f32 instantiation, the plain version and one
    PyTorch call (SDPA in bf16 on the same keys: over the gathered and/or
    dequantized K/V for B5 / B6 / B7) with its bound (bf16 q and o, K/V
    bytes as stored, the bf16 tensor-core peak)."""
    fn, plain = {"B2": (FA.flash_attention, FA.flash_attention_plain),
                 "B5": (FA.packed_flash_attention, FA.packed_flash_attention_plain),
                 "B6": (FA.paged_flash_attention, FA.paged_flash_attention_plain),
                 "B7": (FA.paged_packed_flash_attention,
                        FA.paged_packed_flash_attention_plain)}[kname]
    args32 = tuple(t.float() if torch.is_tensor(t) and t.dtype == torch.bfloat16 else t
                   for t in args16)
    q = args16[0]
    b, hq, sq, d = q.shape
    kv_len, q0 = args16[-2], args16[-1]
    before = fn.bf16_launches
    o = fn(*args16)
    if fn.bf16_launches != before + 1 or o.dtype != torch.bfloat16:
        raise AssertionError(f"{kname} {label}: a bf16 q did not launch the bf16 kernel")
    o32 = fn(*args32)
    pl = plain(*args16)
    torch.cuda.synchronize()
    if not torch.equal(o, o32.to(torch.bfloat16)):
        raise AssertionError(f"{kname} {label}: bf16 kernel != f32 kernel on the upcasts "
                             f"rounded once: max |diff| "
                             f"{float((o.float() - o32).abs().max())}")
    err = float((o.float() - pl.float()).abs().max())
    top = float(pl.float().abs().max())
    if not (torch.isfinite(o).all() and err <= BF16_PLAIN_REL * top):
        raise AssertionError(f"{kname} {label}: kernel vs plain max |diff| {err} > "
                             f"{BF16_PLAIN_REL} * {top}")
    s = dense["s"]
    mask = FA.attention_mask(kv_len, q0, sq, s, causal=True, window=0)
    visible = float(mask.sum())
    nbytes = 2 * q.numel() * 2 + 2 * dense["keys"] * dense["hkv"] * dense["kv_bytes"] + 8 * b \
        + dense.get("table_bytes", 0)
    b_ms, b_by = bound(nbytes, visible * hq * 4 * d, FP16_OPS)
    cold = cold_copies(torch, args16, nbytes)
    ms = cuda_ms(fn, cold, iters=20)
    cold32 = cold_copies(torch, args32, 2 * nbytes)
    f32_ms = cuda_ms(fn, cold32, iters=20)
    del cold32
    plain_ms = cuda_ms(plain, [args16], iters=5)
    lib = dense["library"]
    lib_ms = cuda_ms(lambda *a: lib(*a, mask[:, None]), cold, iters=20)
    del cold
    print(f"  {kname} {label:22s} B={b} Hq={hq} Hkv={dense['hkv']} Sq={sq} S={s} D={d} bf16: "
          f"bit-equal to the f32 kernel on the upcasts, rounded once; |diff| to plain "
          f"{err:.3g} (max|out| {top:.3g}); kernel {ms:.4f} ms (f32 {f32_ms:.4f}), plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), {dense['library_name']} "
          f"{lib_ms:.4f} ms")
    return {"ms": ms, "f32_ms": f32_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": dense["library_name"], "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": err, "max_abs_out": top}


def phase_bf16_kernels(torch, FA, KVQ) -> dict:
    """B2, B5, B6 and B7 on bf16 operands at the main path's shapes:
    llama-7b's prefill (B 4, H 32, S 512, ragged) and decode, phase 8's
    kv8 decode (S 2,048), phase 13's paged decode (8 lanes, bs 16, MB 32,
    shared and idle lanes) and recurrentgemma-2b's MQA decode (Hq 10, Hkv
    1, D 256), each through :func:`bf16_kernel_case`."""
    print("== phase 23 (kernels): B2 / B5 / B6 / B7 on bf16 operands vs the f32 kernel on "
          "the upcasts (bit-equal) and plain (timed cold, SDPA in bf16 beside)")
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(23)
    kv8 = KVQ.KV_PRESETS["kv8"]
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(bf)

    def t32(xs):
        return torch.tensor(xs, dtype=torch.int32, device="cuda")

    def sdpa(q, k, v, mask):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=q.shape[1] != k.shape[1])

    def sdpa_deq(q, kqm, ksc, vqm, vsc, kv_len, q0, mask):
        return sdpa(q, (kqm * ksc).to(bf), (vqm * vsc).to(bf), mask)

    def sdpa_gather(q, pk, pv, table, kv_len, q0, mask):
        return sdpa(q, FA.gather_blocks(pk, table), FA.gather_blocks(pv, table), mask)

    def sdpa_gather_deq(q, kqm, ksc, vqm, vsc, table, kv_len, q0, mask):
        k = (FA.gather_blocks(kqm, table) * FA.gather_blocks(ksc, table)).to(bf)
        v = (FA.gather_blocks(vqm, table) * FA.gather_blocks(vsc, table)).to(bf)
        return sdpa(q, k, v, mask)

    out = {}
    ragged, dec = [2048, 1501, 700, 37], [2047, 1500, 699, 36]
    for model, (hq, hkv, d) in BF16_HEADS.items():
        rg = model != "llama-7b"
        tag = "" if not rg else f"-{model}"
        if not rg:  # B2 at llama-7b's prefill and decode over 512 keys
            k, v = randn(4, hkv, 512, d), randn(4, hkv, 512, d)
            info = {"s": 512, "hkv": hkv, "kv_bytes": 2 * d, "library": lambda q, k, v, _0,
                    _1, mask: sdpa(q, k, v, mask), "library_name": "sdpa bf16"}
            for name, sq, lens, q0 in (("prefill", 512, [512, 300, 129, 77], [0, 0, 0, 0]),
                                       ("decode", 1, [512, 301, 129, 18],
                                        [511, 300, 128, 17])):
                info["keys"] = sum(lens)
                out[("B2", name)] = bf16_kernel_case(
                    torch, FA, KVQ, "B2", f"{model} {name}",
                    (randn(4, hq, sq, d), k, v, t32(lens), t32(q0)), info)
            del k, v
        # decode over 2,048 keys: B2 (recurrentgemma's MQA) and B5 (phase 8's)
        k, v = randn(4, hkv, 2048, d), randn(4, hkv, 2048, d)
        q = randn(4, hq, 1, d)
        if rg:
            out[("B2", "decode" + tag)] = bf16_kernel_case(
                torch, FA, KVQ, "B2", f"{model} decode", (q, k, v, t32(ragged), t32(dec)),
                {"s": 2048, "hkv": hkv, "kv_bytes": 2 * d, "keys": sum(ragged),
                 "library": lambda q, k, v, _0, _1, mask: sdpa(q, k, v, mask),
                 "library_name": "sdpa bf16"})
        kq, vq = KVQ.quantize_kv(k, kv8), KVQ.quantize_kv(v, kv8)
        out[("B5", "decode" + tag)] = bf16_kernel_case(
            torch, FA, KVQ, "B5", f"{model} decode kv8",
            (q, kq.qm, kq.scale, vq.qm, vq.scale, t32(ragged), t32(dec)),
            {"s": 2048, "hkv": hkv, "kv_bytes": d + 4, "keys": sum(ragged),
             "library": sdpa_deq, "library_name": "sdpa bf16 over dequantized K/V"})
        del k, v, kq, vq
        # paged: phase 13's lanes (llama-7b) / B=4 over 2,048 keys with
        # shared blocks (recurrentgemma-2b), float pools then kv8 pools
        if not rg:
            lanes = ((209, 14, 0), (215, 14, 12), (1, 0, 0), (1, 21, 0), (330, 21, 0),
                     (1, 0, 0), (223, 14, 12), (512, 32, 0))
            table, kv_len = _serve_table(torch, gen, lanes, 32, 129)
            nb, name = 129, "serve"
        else:
            perm = (torch.randperm(4 * 128, generator=gen, device="cuda") + 1).to(torch.int32)
            table = perm.reshape(4, 128).clone()
            table[1:, :20] = table[0, :20]
            kv_len, nb, name = t32(ragged), 4 * 128 + 1, "decode" + tag
        pk, pv = randn(nb, hkv, 16, d), randn(nb, hkv, 16, d)
        pkq, pvq = KVQ.quantize_kv(pk, kv8), KVQ.quantize_kv(pv, kv8)
        q = randn(table.shape[0], hq, 1, d)
        q0 = kv_len - 1
        keys = _distinct_keys(table, kv_len, 16)
        common = {"s": table.shape[1] * 16, "hkv": hkv, "keys": keys,
                  "table_bytes": table.numel() * 4}
        out[("B6", name)] = bf16_kernel_case(
            torch, FA, KVQ, "B6", f"{model} paged {name}",
            (q, pk, pv, table, kv_len, q0),
            {**common, "kv_bytes": 2 * d, "library": sdpa_gather,
             "library_name": "gather + sdpa bf16"})
        out[("B7", name)] = bf16_kernel_case(
            torch, FA, KVQ, "B7", f"{model} paged {name} kv8",
            (q, pkq.qm, pkq.scale, pvq.qm, pvq.scale, table, kv_len, q0),
            {**common, "kv_bytes": d + 4, "library": sdpa_gather_deq,
             "library_name": "gather + dequantize + sdpa bf16"})
        del pk, pv, pkq, pvq
    torch.cuda.empty_cache()
    return out


def phase_bf16_cross_device(torch, TM, Engine, ServeConfig, cfg) -> dict:
    """23a: llama-7b-paper at full width and CROSS_LAYERS layers in bf16,
    packed "precise" (drawn and packed by ``init(pack=)`` on the card, a CPU
    copy of the packed model): a ragged generate on the CPU (plain
    versions) and the card (kernels), float KV then kv8, the sampled
    batches held under phase 9's rule at the bf16 near-tie bound."""
    print(f"== phase 23a: llama-7b-paper bf16 at full width, {CROSS_LAYERS} layer(s), packed: "
          f"CPU (plain) vs card (kernels), float KV and kv8")
    c = cfg.replace(n_layers=CROSS_LAYERS)
    model = TM.init(c, seed=23, device="cuda", pack="precise")
    cpu_model = copy.deepcopy(model).to("cpu")
    toks, lens = _prompts(cfg.vocab_size, [5, 17, 9, 12], seed=23)
    out = {}
    for kv in (None, "kv8"):
        scfg = ServeConfig(max_len=64, kv_quant=kv)
        t0 = time.perf_counter()
        tapes, outs = [], []
        for m, dev in ((cpu_model, "cpu"), (model, "cuda")):
            eng = Engine(m, scfg, device=dev)
            tape = SampleTape(eng, cfg.vocab_size)
            outs.append(eng.generate(toks, 8, lengths=lens))
            tapes.append(tape.close())
        for lg, _ in tapes[1]:
            if not torch.isfinite(lg).all():
                raise AssertionError("23a: non-finite bf16 logits on the card")
        at, equal, worst = check_calls(torch, *tapes, tie_ulps=BF16_TIE_ULPS)
        label = kv or "float KV"
        print(f"  {label}: generate (lens {lens.tolist()}, 8 new): logits within {worst:.2e} of "
              f"max|logit| (limit {KV_TIE}), {equal} of {len(tapes[0])} batches bit-equal, "
              + ("every token equal" if at is None else f"near tie at batch {at}")
              + f"; {time.perf_counter() - t0:.1f} s; card {outs[1][0].tolist()}")
        out[label] = {"max_rel_logit_diff": worst, "equal_batches": equal,
                      "near_tie_batch": at}
    del model, cpu_model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_bf16_serve(torch, TM, Engine, ServeConfig, Request, TO, KVQ, blocks, kernels, cfg,
                     float_bpt=None) -> dict:
    """23: llama-7b-paper in bf16 at full width and depth, drawn and packed
    by ``init(pack=)`` (peak gated), phase 5's traffic through generate and
    the dense serve, float KV then kv8, launches counted in every decode
    step (B1 224, B2 / B5 32), KV bytes per token (half of phase 5's float
    figure), prefill s, ms per step, peak memory and a 2-step trace; then
    at SPEC_LAYERS layers phase 13's paged traffic (float pool, kv8 pool;
    paged == dense at matched batches) and a speculative serve against
    spec_k 0."""
    from repro_torch.serve.engine import _nbytes

    n = cfg.n_layers
    print(f"== phase 23: llama-7b-paper in bf16 at full width and depth ({n} layers), "
          f"init(pack=): generate + serve, float KV then kv8; paged and speculation at "
          f"{SPEC_LAYERS} layers")
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 2)
        t_lap[0] = now

    transient, (tk, tn) = pack_transient(torch, cfg)
    torch.cuda.reset_peak_memory_stats()
    model = TM.init(cfg, seed=0, device="cuda", pack="precise")
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    lap("init(pack=)")
    packed = _nbytes(model)
    layer = TM.Model(cfg.replace(n_layers=1), "meta").layers[0]
    layer_bytes = sum(p.numel() * p.element_size() for p in layer.parameters())
    draw_f32 = 4 * max(p.numel() for p in layer.parameters())  # one draw's f32 tensor
    init_limit = packed + layer_bytes + draw_f32 + transient + INIT_SLACK
    if {p.dtype for p in model.parameters()} != {torch.bfloat16}:
        raise AssertionError(f"bf16 llama parameters of dtypes "
                             f"{ {p.dtype for p in model.parameters()} }")
    print(f"  init(pack=) {laps['init(pack=)']:.2f} s: {packed / 1e9:.2f} GB packed (bf16 "
          f"embedding, head and norms); peak {init_peak / 1e9:.2f} GB = packed + "
          f"{(init_peak - packed) / 1e9:.2f} GB; limit {init_limit / 1e9:.2f} GB = packed + "
          f"one bf16 layer {layer_bytes / 1e9:.2f} GB + one f32 draw {draw_f32 / 1e9:.2f} GB + "
          f"the pack's transient at K={tk} N={tn} {transient / 1e9:.2f} GB + "
          f"{INIT_SLACK // 2**20} MiB")
    if init_peak > init_limit:
        raise AssertionError(f"bf16 init(pack=) peaked at {init_peak / 1e9:.2f} GB > "
                             f"{init_limit / 1e9:.2f} GB")
    toks, lens, reqs = _serve_traffic(Request, cfg.vocab_size)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for kv in (None, "kv8"):
        name = kv or "float"
        attn = "packed_flash_attention" if kv else "flash_attention"
        eng = Engine(model, ServeConfig(max_len=512, batch_size=4, kv_quant=kv),
                     device="cuda")
        if eng.pack_report is not None:
            raise AssertionError("the engine repacked a packed model")
        # ---- the bf16 main path: counts from 0 over exactly this run ----
        _reset_launches(kernels)
        counter = StepCounter(eng, kernels, TO)
        tape = SampleTape(eng, cfg.vocab_size)
        try:
            out = eng.generate(toks, 16, lengths=lens)
            gst = dict(eng.last_stats)
            served = eng.serve(reqs, max_new_tokens=16)
            torch.cuda.synchronize()
        finally:
            calls = tape.close()
            steps, _, _ = counter.close()
        launches = {k: fn.launches for k, fn in kernels.items()}
        bf16 = {k: fn.bf16_launches for k, fn in kernels.items() if hasattr(fn, "bf16_launches")}
        sst = dict(eng.last_stats)
        lap(f"generate + serve, {name}")
        step = _per_step([c for c, _ in steps], f"bf16 {name}")
        if step != {"dsbp_fused": 7 * n, attn: n}:
            raise AssertionError(f"bf16 {name}: a decode step launched {step}, want "
                                 f"dsbp_fused {7 * n}, {attn} {n}")
        if bf16[attn] != launches[attn] or launches[attn] <= 0:
            raise AssertionError(f"bf16 {name}: {attn} launched {launches[attn]} times, "
                                 f"{bf16[attn]} of them bf16")
        if out.shape != (4, 16) or sorted(served) != list(range(8)) or any(
                len(t) != 16 for t in served.values()):
            raise AssertionError(f"bf16 {name}: generate {out.shape} / serve lengths wrong")
        for lg, tok in calls:
            if not torch.isfinite(lg).all() or not torch.equal(lg.argmax(-1), tok):
                raise AssertionError(f"bf16 {name}: sampled logits not finite or not greedy")
        bpt = sst["kv_bytes_per_token"]
        want = 2 * n * cfg.n_kv_heads * (2 * cfg.d_head if kv is None else cfg.d_head + 4)
        if bpt != want:
            raise AssertionError(f"bf16 {name}: {bpt} KV bytes per token, want {want}")
        runs[name] = {"launches": launches, "bf16_launches": bf16, "step_launches": step,
                      "prefill_s": gst["prefill_s"],
                      "decode_ms": 1e3 * gst["decode_s"] / gst["decode_steps"],
                      "serve_ms": 1e3 * sst["decode_time_s"] / sst["decode_steps"],
                      "serve_prefill_s": sst["prefill_time_s"], "kv_bytes_per_token": bpt}
        print(f"  {name} KV: generate prefill {gst['prefill_s']:.3f} s, "
              f"{runs[name]['decode_ms']:.2f} ms per decode step; serve {sst['decode_steps']} "
              f"steps, {runs[name]['serve_ms']:.2f} ms/step, prefill "
              f"{sst['prefill_time_s']:.3f} s; per decode step {step} (bf16 {attn}: "
              f"{bf16[attn]} of {launches[attn]}); KV bytes per token {bpt:.0f}")
        if kv is None:
            runs[name]["trace"] = trace_decode(torch, eng, toks, lens, TRACE_FUSED, steps=2)
            lap("trace")
        del eng
    peak = torch.cuda.max_memory_allocated()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    half = runs["float"]["kv_bytes_per_token"] / (float_bpt or 2 * n * cfg.n_kv_heads
                                                    * cfg.d_head * 4)
    print(f"  peak memory {peak / 2**30:.2f} GiB; float-KV bytes per token "
          f"{half:.3f} of the f32 model's" + (" (phase 5)" if float_bpt else ""))
    if half != 0.5:
        raise AssertionError(f"bf16 KV bytes per token are {half} of f32's")
    # phase 13's paged traffic and speculation at SPEC_LAYERS layers (full
    # width; cut for the script's time limit): paged float and kv8 pools,
    # then spec_k 3 against spec_k 0
    cfgs = cfg.replace(n_layers=SPEC_LAYERS)
    smodel = TM.init(cfgs, seed=0, device="cuda", pack="precise")
    paged = phase_paged_serve(torch, Engine, ServeConfig, Request, TO, KVQ, blocks, kernels,
                              smodel, cfgs, label="23 (paged)", kv_tie=BF16_KV_TIE)
    lap("paged")
    for name, k in (("float", "paged_flash_attention"), ("kv8", "paged_packed_flash_attention")):
        if paged[name]["bf16_launches"][k] != paged[name]["launches"][k]:
            raise AssertionError(f"bf16 paged {name}: {k} launched "
                                 f"{paged[name]['launches'][k]} times, "
                                 f"{paged[name]['bf16_launches'][k]} of them bf16")
    base = Engine(smodel, ServeConfig(max_len=512, batch_size=4), device="cuda")
    tape = GuardTape(base, cfg.vocab_size)
    try:
        ref = base.serve(reqs)
    finally:
        tape.close()
    del base
    spec = _spec_serve(torch, Engine, ServeConfig, TO, kernels, smodel, cfgs, reqs, ref,
                       tape.rows, dict(max_len=512, batch_size=4, spec_draft_bits=4),
                       f"bf16 dense float, {SPEC_LAYERS} layers, draft bits 4")
    del smodel
    gc.collect()
    torch.cuda.empty_cache()
    lap("speculation")
    print(f"  seconds by part: {laps}")
    return {"init_s": laps["init(pack=)"], "init_peak": init_peak, "init_limit": init_limit,
            "packed_bytes": packed, "peak": peak, "seconds_by_part": laps, **runs,
            "paged": {k: {"launches": v["launches"],
                          "ms_step": 1e3 * v["stats"]["decode_time_s"]
                          / v["stats"]["decode_steps"],
                          "kv_bytes_per_token": v["stats"]["kv_bytes_per_token"]}
                      for k, v in paged.items()},
            "spec": {**{k: spec[k] for k in ("ms_round", "ms_token", "ties", "worst",
                                             "launches")},
                     "b1_m": {f"{step} M={m}": c for (step, m), c in spec["b1_m"].items()},
                     "accepted_hist": spec["stats"]["accepted_hist"]}}


def phase_bf16_families(torch, TM, Engine, ServeConfig, get_config) -> dict:
    """23b: a bf16 generate of each other family at full width, cut in
    depth (BF16_FAMILIES), packed "precise", on the CPU (plain versions)
    and the card (kernels): sampled batches under phase 9's rule at the
    bf16 near-tie bound, per codebook."""
    out = {}
    for arch, cut in BF16_FAMILIES.items():
        c = get_config(arch).replace(dtype="bfloat16", quant="precise", **cut)
        print(f"== phase 23b: {arch} bf16 at full width, {cut} (reduced), packed: CPU (plain) "
              f"vs card (kernels)")
        t0 = time.perf_counter()
        model = TM.init(c, seed=23, device="cuda", pack="precise")
        cpu_model = copy.deepcopy(model).to("cpu")
        toks, lens, extra = frontend_inputs(c, BF16_FAMILY_LENS.get(arch, [9, 30, 17, 5]),
                                            seed=23)
        scfg = ServeConfig(max_len=max(lens) + c.n_image_tokens + 16, batch_size=len(lens))
        tapes, outs = [], []
        for m, dev in ((cpu_model, "cpu"), (model, "cuda")):
            eng = Engine(m, scfg, device=dev)
            tape = SampleTape(eng, 10**9)
            outs.append(eng.generate(toks, BF16_FAMILY_NEW, extra=extra, lengths=lens))
            tapes.append(codebook_calls(tape.close(), c))
        for lg, _ in tapes[1]:
            if not torch.isfinite(lg).all():
                raise AssertionError(f"23b {arch}: non-finite bf16 logits on the card")
        at, equal, worst = check_calls(torch, *tapes, tie_ulps=BF16_TIE_ULPS,
                                       kv_tie=BF16_MOE_TIE if c.n_experts else KV_TIE)
        print(f"  generate (lens {lens.tolist()}"
              + (f" + {c.n_image_tokens} image tokens" if extra else "")
              + f", {BF16_FAMILY_NEW} new): logits within {worst:.2e} of max|logit| (limit "
              f"{BF16_MOE_TIE if c.n_experts else KV_TIE}), {equal} of {len(tapes[0])} batches "
              f"bit-equal, "
              + ("every token equal" if at is None else f"near tie at batch {at}")
              + f"; {time.perf_counter() - t0:.1f} s")
        out[arch] = {"max_rel_logit_diff": worst, "equal_batches": equal,
                     "near_tie_batch": at, "cut": cut}
        del model, cpu_model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def bf16_phases(torch, TM, Engine, ServeConfig, Request, FA, TO, KVQ, blocks, kernels,
                get_config, float_bpt=None, kern=None) -> dict:
    """Phase 23 whole: the bf16 kernels (``kern``, where they were timed
    already), 23a, 23 and 23b; prints one ``bf16 (phase 23):`` JSON line and
    returns the records."""
    t0 = time.perf_counter()
    cfg = get_config("llama-7b-paper").replace(dtype="bfloat16")
    if kern is None:
        kern = phase_bf16_kernels(torch, FA, KVQ)
    cross = phase_bf16_cross_device(torch, TM, Engine, ServeConfig, cfg)
    serve = phase_bf16_serve(torch, TM, Engine, ServeConfig, Request, TO, KVQ, blocks, kernels,
                             cfg, float_bpt)
    fam = phase_bf16_families(torch, TM, Engine, ServeConfig, get_config)
    rec = {"kernels": {f"{k} {c}": v for (k, c), v in kern.items()}, "23a": cross,
           "23": {k: v for k, v in serve.items()}, "23b": fam,
           "seconds": time.perf_counter() - t0, "card": smi()}
    print("bf16 (phase 23): " + json.dumps(rec, default=str))
    return {"kernels": kern, "serve": serve, "cross": cross, "families": fam}


# ---------------------------------------------------------------------------
# phase 24: the training path
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_BF16_STEPS = 8, 4, 4
TRAIN_CROSS_BATCH, TRAIN_CROSS_SEQ = 2, 64
STE_M = TRAIN_BATCH * TRAIN_SEQ  # 24k: the straight-through products' rows, phase 24's
# 24a, CPU vs card, one step: each parameter's gradient within these
# relative norms.  Float: every product is an f32 matmul or reduction taken
# in another order.  "precise": the forward also quantizes every projection
# input to FP8, and a last-bit difference upstream (the attention kernel's
# sum order against its plain version's) rounds some inputs the other way,
# which moves that row's output and so the gradients of every parameter it
# reaches (ROADMAP C's near ties; 24a counts them).  The QAT limit lies
# between two readings that 24a takes again in every run: last-bit noise
# below it (card vs CPU 3.4e-3; the card against itself from weights one
# ulp away 3.0e-2, the head and the final norm), three planted faults
# above it (0.40 to 1.0); 0.1 leaves 3.4x room above the one and 4x below
# the other (an H100 card; PERF.md §6)
TRAIN_FLOAT_REL = 1e-5
TRAIN_GRAD_REL = 0.1
TRAIN_PEAK_GIB = 25.0  # the line above which a phase takes the lock
TRACE_TRAIN_RANGES = ("ste_backward", "flash_attention_backward", "adamw_update")


def f32_dot_rel(n: int) -> float:
    """24k's limit for an f32 product against float64, in norm, where
    each output is an n-term dot: 2^-24 * sqrt(n).  cuBLAS accumulates a
    dot in sequence, whose rounding errors add up to ~2^-24 * sqrt(n / 6)
    of the result for random data (on an H100 at M 2,048: 0.30 * 2^-24 *
    sqrt(n) for gx at n 4,096 and gw at n 2,048)."""
    return 2.0 ** -24 * math.sqrt(n)


def _train_cfg(get_config, n_layers: int, dtype: str = "float32"):
    return get_config("llama-7b-paper").replace(n_layers=n_layers, quant="precise",
                                               quant_method="dsbp_fused", dtype=dtype)


def _plain_rows(torch, fn, *xs):
    """``fn`` over row blocks of PLAIN_ROWS: the plain versions' float64
    group dots take n_groups * rows * N * 8 bytes (11.5 GB at M 2,048, K
    11,008), and every output row depends on its own input row only, so
    the blocks give the whole product's bits."""
    return torch.cat([fn(*(t[i:i + PLAIN_ROWS] for t in xs))
                      for i in range(0, xs[0].shape[0], PLAIN_ROWS)])


def fused_plain(x, w, c):
    """B1's straight-through forward with its plain version, on x's device."""
    import torch

    from repro_torch.core import quantized as Q
    from repro_torch.core.formats import per_tensor_scale
    from repro_torch.kernels import dsbp_fused as DF

    pw = Q.pack_weights(w, c)
    ts = per_tensor_scale(x, c.input_cfg.fmt).reshape(1)
    return _plain_rows(torch, lambda xb: DF.dsbp_fused_plain(
        xb, ts, pw.ka, pw.kscale, pw.tscale.reshape(-1), c.input_cfg), x)


def kernel_plain(x, w, c):
    """B3 + B4's straight-through forward with their plain versions."""
    import torch

    from repro_torch.core import quantized as Q
    from repro_torch.core.formats import per_tensor_scale
    from repro_torch.kernels import dsbp_matmul as DM
    from repro_torch.kernels import fp8_quant_align as QA

    pw = Q.pack_weights(w, c)
    ts = per_tensor_scale(x, c.input_cfg.fmt)
    a, sx, _ = QA.fp8_quant_align_plain(x * ts, c.input_cfg)
    return _plain_rows(torch, lambda ab, sb: DM.dsbp_matmul_plain(ab, sb, pw.ka, pw.kscale),
                       a, sx) / (ts * pw.tscale.reshape(1, -1))


def ste_case(torch, name: str, fn, plain, kernels, gen, cfg, m: int, kk: int, n: int) -> dict:
    """One straight-through product ``fn`` (x (m, kk) @ w (kk, n), seeded)
    on the card: its forward launches each of ``kernels`` once and is
    bit-equal to ``plain``; gx / gw bit-equal to the formula's f32
    products gy wᵀ / xᵀ gy and within f32_dot_rel of float64 in norm."""
    w = torch.randn(kk, n, generator=gen, device="cuda") * kk ** -0.5
    x = torch.randn(m, kk, generator=gen, device="cuda")
    gy = torch.randn(m, n, generator=gen, device="cuda")
    counts = _launch_counts(kernels)
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = fn(xs, ws, cfg)
    launched = {kn: c - counts[kn] for kn, c in _launch_counts(kernels).items()}
    if any(c != 1 for c in launched.values()):
        raise AssertionError(f"{name} STE forward launched {launched}")
    gx, gw = torch.autograd.grad(y, (xs, ws), gy)
    ref = plain(x, w, cfg)
    if not torch.equal(y.detach(), ref):
        raise AssertionError(f"{name} STE forward != its plain version at M={m} K={kk} N={n}: "
                             f"{float((y.detach() - ref).abs().max())}")
    # the straight-through backward is JAX's _ste_bwd, two f32 products:
    # bit-equal to the same products taken outside the Function, and each
    # within f32_dot_rel of float64 on the card
    if not (torch.equal(gx, gy @ w.T) and torch.equal(gw, x.T @ gy)):
        raise AssertionError(f"{name} gx / gw != the f32 products gy wᵀ / xᵀ gy")
    xd, wd, gd = x.double(), w.double(), gy.double()
    exact = (gd @ wd.T, xd.T @ gd)
    del xd, wd, gd
    rx, rw = (float(torch.linalg.vector_norm(a.double() - b_) / torch.linalg.vector_norm(b_))
              for a, b_ in zip((gx, gw), exact))
    mx, mw = (float((a.double() - b_).abs().max() / b_.abs().max())
              for a, b_ in zip((gx, gw), exact))
    del exact
    lx, lw = f32_dot_rel(n), f32_dot_rel(m)  # gx sums over N, gw over M
    if not (rx <= lx and rw <= lw):
        raise AssertionError(f"{name} gx / gw vs float64 {rx} / {rw} > {lx} / {lw}")
    print(f"  {name} STE M={m} K={kk:5d} N={n:5d}: forward bit-equal to its plain "
          f"version; gx, gw bit-equal to the f32 products and within {rx:.2e}, "
          f"{rw:.2e} of float64's norm (limits {lx:.2e}, {lw:.2e}; largest element "
          f"{mx:.2e}, {mw:.2e} of max|.|); launched {launched}")
    return {"gx_rel_norm": rx, "gw_rel_norm": rw, "gx_rel_max": mx, "gw_rel_max": mw}


def b2_grad_case(torch, FA, q, k, v, kv_len, q0, g, window: int = 0) -> list:
    """B2's autograd function (``flash_attention_grad``: the kernel's
    forward, the plain version's backward) against the plain version's
    autograd under the cotangent ``g``: [output, dq, dk, dv] relative to
    max|.|, each within 1e-5, or it raises; the forward launches B2 once."""
    grads = {}
    for name in ("kernel", "plain"):
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = FA.flash_attention.launches
        fn = FA.flash_attention_grad if name == "kernel" else FA.flash_attention_plain
        o = fn(*qkv, kv_len, q0, causal=True, window=window)
        launched = FA.flash_attention.launches - before
        if launched != (name == "kernel"):
            raise AssertionError(f"B2 launched {launched} times in the {name} forward")
        grads[name] = (o.detach(), *torch.autograd.grad(o, qkv, g))
        del qkv, o
    rel = [float((a - b_).abs().max() / b_.abs().max())
           for a, b_ in zip(grads["kernel"], grads["plain"])]
    if not max(rel) <= 1e-5:
        raise AssertionError(f"B2's output / dq / dk / dv vs plain {rel} > 1e-5")
    return rel


def phase_train_kernels(torch, Q, DF, FA, TO) -> dict:
    """24k: the kernel Functions' gradients on the card against the plain
    versions' autograd gradients: B2 (``flash_attention_grad``) at
    llama-7b's prefill (B 4, H 32, S 512, D 128, ragged kv_len), its
    output within 1e-5 of plain and q / k / v gradients within 1e-5; the
    'dsbp_fused' (B1) and 'dsbp_kernel' (B3 + B4) straight-through
    products at the three projection shapes and phase 24's rows (M =
    STE_M): the forward bit-equal to the same product through the kernels'
    plain versions (over row blocks of PLAIN_ROWS, on the card), gx / gw
    bit-equal to the straight-through formula's f32 products and within
    f32_dot_rel of them in float64 on the card."""
    print("== phase 24k: the training Functions on the card: B2's gradient, the "
          "straight-through products")
    gen = torch.Generator(device="cuda").manual_seed(24)
    out = {}
    b, h, s, d = 4, 32, 512, 128
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda") for _ in range(3))
    kv_len = torch.tensor([512, 301, 144, 32], dtype=torch.int32, device="cuda")
    q0 = torch.zeros(b, dtype=torch.int32, device="cuda")
    g = torch.randn(b, h, s, d, generator=gen, device="cuda")
    g = g * (torch.arange(s, device="cuda")[None, None, :, None] < kv_len[:, None, None, None])
    rel = b2_grad_case(torch, FA, q, k, v, kv_len, q0, g)
    print(f"  B2 B={b} H={h} S={s} D={d} ragged {kv_len.tolist()}: output, dq, dk, dv within "
          f"{['%.2e' % r for r in rel]} of the plain version's autograd (limit 1e-5)")
    out["B2"] = {"rel_out_dq_dk_dv": rel}
    del q, k, v, g
    cfg = Q.PRESETS["precise"]
    for name, fn, plain, kernels in (
            ("dsbp_fused", TO.dsbp_matmul_fused_ste, fused_plain, ("dsbp_fused",)),
            ("dsbp_kernel", TO.dsbp_matmul_ste, kernel_plain, ("fp8_quant_align",
                                                              "dsbp_matmul"))):
        for kk, n in LLAMA_SHAPES:
            out[f"{name} K={kk} N={n}"] = ste_case(torch, name, fn, plain, kernels, gen, cfg,
                                                   STE_M, kk, n)
    torch.cuda.empty_cache()
    return out


def _launch_counts(names) -> dict:
    from repro_torch.kernels import dsbp_fused as DF
    from repro_torch.kernels import dsbp_matmul as DM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fp8_quant_align as QA

    fns = {"dsbp_fused": DF.dsbp_fused, "flash_attention": FA.flash_attention,
           "fp8_quant_align": QA.fp8_quant_align, "dsbp_matmul": DM.dsbp_matmul}
    return {n: fns[n].launches for n in names}


def _loss_and_grads(torch, TM, adamw, model, batch, quant):
    """The forward and backward of a train step: (loss, {name: gradient})."""
    params = adamw.trainable(model)
    loss, _ = TM.loss_fn(model, batch, quant)
    return float(loss.detach()), dict(zip(params, torch.autograd.grad(loss,
                                                                      list(params.values()))))


@contextlib.contextmanager
def _fused_ste_as(TO, fn):
    """``ops.dsbp_matmul_fused_ste`` (what the 'dsbp_fused' method's raw
    path calls) replaced by ``fn(orig, x, w, cfg)`` for the block."""
    orig = TO.dsbp_matmul_fused_ste
    TO.dsbp_matmul_fused_ste = lambda x, w, c: fn(orig, x, w, c)
    try:
        yield
    finally:
        TO.dsbp_matmul_fused_ste = orig


def _train_faults(torch, TO, STEProduct, target: str, k: int, n: int):
    """Planted faults of the QAT product, each a kernel or backward bug
    that a CPU-vs-card gradient limit must catch: B1's K loop one 64-group
    short (every product), the output scale of the products of weight
    shape (k, n) (``target``: w2, or a family's own) off by one power of
    two, and their weight gradient lost."""
    def short_k(orig, x, w, c):
        def fwd(x_, w_, c_):
            return TO._fused_forward(torch.cat([x_[..., :-64], torch.zeros_like(x_[..., -64:])],
                                               -1), w_, c_)
        return STEProduct.apply(x, w, c, fwd)

    def out_scale(orig, x, w, c):
        if tuple(w.shape) != (k, n):
            return orig(x, w, c)
        return STEProduct.apply(x, w, c, lambda *a: 2 * TO._fused_forward(*a))

    def no_grad(orig, x, w, c):
        if tuple(w.shape) != (k, n):
            return orig(x, w, c)
        return orig(x, w.detach(), c) + 0 * w.sum()

    return {"B1 one group short": short_k, f"{target} output x2": out_scale,
            f"{target} gradient lost": no_grad}


def _grad_rels(torch, got: dict, ref: dict) -> list:
    """[(relative norm of got[k] - ref[k], k)], largest first, on ref's
    device, the sums of squares in float64 over chunks of 2^26 elements
    (an expert stack's float64 copy would be 3.8 GB)."""
    step = 1 << 26
    rels = []
    for k, g in ref.items():
        a, g = got[k].to(g.device).reshape(-1), g.reshape(-1)
        num = den = 0.0
        for i in range(0, g.numel(), step):
            gd = g[i:i + step].double()
            num += float(torch.sum((a[i:i + step].double() - gd) ** 2))
            den += float(torch.sum(gd * gd))
        rels.append((math.sqrt(num / den) if den else (0.0 if num == 0 else math.inf), k))
    return sorted(rels, reverse=True)


def _fp8_flips(torch, DF, per_tensor_scale, cfg, xs_a: list, xs_b: list) -> list:
    """For each pair of one product's inputs on the two sides: (elements,
    elements that differ in any bit, elements whose FP8 value after B1's
    quantize and align differs, groups whose predicted width differs)."""
    out = []
    for a, b in zip(xs_a, xs_b):
        q = []
        for x in (a, b):
            x = x.reshape(-1, x.shape[-1]).to(torch.float32)
            ts = per_tensor_scale(x, cfg.fmt)
            m, s, bits = DF.quant_align_tile(x * ts, cfg)
            q.append(((m.reshape(m.shape[0], -1, 64) * s[..., None]) / ts, bits))
        out.append((a.numel(), int((a != b).sum()), int((q[0][0] != q[1][0]).sum()),
                    int((q[0][1] != q[1][1]).sum())))
    return out


def phase_train_cross_device(torch, TM, adamw, get_config, SyntheticLM, DataConfig) -> dict:
    """24a: llama-7b-paper at full width and CROSS_LAYERS layers, the
    forward and backward of one train step on the CPU (plain versions) and
    on the card (kernels) from the same weights and batch, twice: float (no
    quantization), every gradient within TRAIN_FLOAT_REL of its norm; then
    "precise" through 'dsbp_fused' (weights packed per call,
    straight-through backward), the losses within phase 9's relative bound
    and every gradient within TRAIN_GRAD_REL.  The QAT limit is read
    against both sides of it on the card: the card's step from weights one
    ulp away (the last-bit noise an honest run carries) stays within it,
    and each planted fault (_train_faults) lies above it; the inputs of
    each product that round to another FP8 value on the CPU than on the
    card are counted.  Without remat (phase 24 trains with it) and without
    the AdamW update (phase 24 runs it; the CPU tests hold it to JAX's):
    the CPU's side is the costly part."""
    print(f"== phase 24a: llama-7b-paper at full width, {CROSS_LAYERS} layer(s), one train "
          f"step: CPU (plain) vs card (kernels)")
    from repro_torch.core.formats import per_tensor_scale
    from repro_torch.core.quantized import PRESETS, STEProduct
    from repro_torch.kernels import dsbp_fused as DF
    from repro_torch.kernels import ops as TO
    from repro_torch.models.layers import Quant

    out = {}
    cfg = _train_cfg(get_config, CROSS_LAYERS).replace(remat=False)
    batch = SyntheticLM(DataConfig(seed=24, batch_size=TRAIN_CROSS_BATCH,
                                   seq_len=TRAIN_CROSS_SEQ), cfg).batch(0)
    cpu_model = TM.init(cfg, seed=24, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")

    def recorded(xs):
        def rec(orig, x, w, c):
            xs.append(x.detach().to("cpu", copy=True))
            return orig(x, w, c)
        return rec

    for label, quant, limit in (("float", Quant(None), TRAIN_FLOAT_REL),
                                ("precise, dsbp_fused", Quant("precise", "dsbp_fused"),
                                 TRAIN_GRAD_REL)):
        t0 = time.perf_counter()
        xs_card, xs_cpu = [], []
        counts = _launch_counts(("dsbp_fused", "flash_attention"))
        with _fused_ste_as(TO, recorded(xs_card)):
            gl, gg = _loss_and_grads(torch, TM, adamw, gpu_model, batch, quant)
        launched = {k: c - counts[k] for k, c in _launch_counts(counts).items()}
        want = {"dsbp_fused": 7 * CROSS_LAYERS if quant else 0,
                "flash_attention": CROSS_LAYERS}
        if launched != want:
            raise AssertionError(f"24a {label}: launches in one train step {launched}, "
                                 f"want {want}")
        rec = {}
        if quant:
            # both sides of the limit, on the card: last-bit noise, planted faults
            nudged = copy.deepcopy(gpu_model)
            with torch.no_grad():
                for p in nudged.parameters():
                    p.copy_(torch.nextafter(p, torch.full_like(p, math.inf)))
            nl, ng_ = _loss_and_grads(torch, TM, adamw, nudged, batch, quant)
            del nudged
            rec["one ulp"] = (abs(nl - gl) / abs(gl), _grad_rels(torch, ng_, gg)[:2])
            del ng_
            for name, fault in _train_faults(torch, TO, STEProduct, "w2", cfg.d_ff,
                                             cfg.d_model).items():
                with _fused_ste_as(TO, fault):
                    fl, fg = _loss_and_grads(torch, TM, adamw, gpu_model, batch, quant)
                rec[name] = (abs(fl - gl) / abs(gl), _grad_rels(torch, fg, gg)[:2])
                del fg
        with _fused_ste_as(TO, recorded(xs_cpu)):
            cl, cg = _loss_and_grads(torch, TM, adamw, cpu_model, batch, quant)
        rel_loss = abs(gl - cl) / abs(cl)
        rels = _grad_rels(torch, gg, cg)
        print(f"  {label}, batch {TRAIN_CROSS_BATCH} x {TRAIN_CROSS_SEQ}: loss card {gl:.6f}, "
              f"CPU {cl:.6f} (relative {rel_loss:.2e}, limit {KV_TIE}); gradients within "
              f"{rels[0][0]:.2e} of the CPU's norm (limit {limit}; largest "
              f"{[(k, float('%.2e' % r)) for r, k in rels[:4]]}); launched {launched}; "
              f"{time.perf_counter() - t0:.1f} s")
        if not (math.isfinite(gl) and rel_loss <= KV_TIE):
            raise AssertionError(f"24a {label}: loss card {gl} vs CPU {cl}")
        if not rels[0][0] <= limit:
            raise AssertionError(f"24a {label}: gradient of {rels[0][1]} card vs CPU "
                                 f"{rels[0][0]} > {limit}")
        out[label] = {"loss_card": gl, "loss_cpu": cl, "rel_loss": rel_loss,
                      "worst_grads": rels[:4], "launches": launched}
        if quant:
            flips = _fp8_flips(torch, DF, per_tensor_scale, PRESETS["precise"].input_cfg,
                               xs_card, xs_cpu)
            print(f"  the {len(flips)} products' inputs, card vs CPU: (elements, differing in "
                  f"any bit, rounding to another FP8 value, groups of another predicted "
                  f"width) {flips}")
            for name, (lr, worst) in rec.items():
                print(f"  card vs card, {name}: loss {lr:.2e} apart, gradients "
                      f"{[(k, float('%.2e' % r)) for r, k in worst]}")
            noise = max(rels[0][0], rec["one ulp"][1][0][0])
            caught = min(r[1][0][0] for n, r in rec.items() if n != "one ulp")
            if not noise <= limit < caught:
                raise AssertionError(f"24a: the QAT limit {limit} does not separate last-bit "
                                     f"noise ({noise:.2e}) from the planted faults "
                                     f"({caught:.2e})")
            out[label].update(fp8_flips=flips, readings=rec)
        del gg, cg
    del cpu_model, gpu_model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _dir_gib(path: Path) -> float:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file()) / 2**30


def trace_train_step(torch, model, opt_state, batch, ocfg) -> dict:
    """One train step in a torch.profiler window (CPU and CUDA activity, so
    the package's ranges attribute their kernels): device time of B1 (by
    kernel name), the straight-through products' backward, the attention
    backward and the optimizer (by range), everything else, and the idle
    share of the window."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.trainer import train_step

    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt_state, _ = train_step(model, opt_state, batch, ocfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # a range also shows on the device timeline as an annotation spanning
    # its kernels: kernels only count as busy time; a range's device time
    # is its host-side entry's, the kernels it launched
    dev = [e for e in events if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
           and e.key not in TRACE_TRAIN_RANGES and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    b1 = sum(e.self_device_time_total for e in dev
             if any(p in e.key for p in TRACE_FUSED["B1"])) / 1e3
    ranges = {e.key: e.device_time_total / 1e3 for e in events
              if e.key in TRACE_TRAIN_RANGES and e.device_type == DeviceType.CPU}
    named = b1 + sum(ranges.values())
    out = {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms if busy else None,
           "B1_ms": b1, **{f"{k}_ms": ranges.get(k, 0.0) for k in TRACE_TRAIN_RANGES},
           "other_ms": busy - named}
    print(f"  trace, one train step (torch.profiler, CPU and CUDA activity): window "
          f"{wall_ms:.1f} ms, device busy {busy:.1f} ms, idle share "
          f"{out['idle_share'] if busy else float('nan'):.3f}; B1 {b1:.1f} ms, "
          + ", ".join(f"{k} {ranges.get(k, 0.0):.1f} ms" for k in TRACE_TRAIN_RANGES)
          + f", everything else {busy - named:.1f} ms")
    return out, opt_state


@contextlib.contextmanager
def _timed_store(store, seconds: dict):
    """``store.save`` and ``store.restore`` (what the Trainer calls) timed
    into ``seconds["save"]`` / ``seconds["restore"]`` for the block."""
    orig = {k: getattr(store, k) for k in ("save", "restore")}

    def timed(kind):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = orig[kind](*a, **kw)
            seconds[kind].append(time.perf_counter() - t0)
            return out
        return call

    for k in orig:
        setattr(store, k, timed(k))
    try:
        yield
    finally:
        for k, fn in orig.items():
            setattr(store, k, fn)


def phase_train(torch, TM, Engine, ServeConfig, adamw, store, get_config, SyntheticLM,
                DataConfig, Trainer, TrainConfig) -> dict:
    """24: llama-7b-paper at full width and TRAIN_LAYERS layers, f32,
    "precise" through 'dsbp_fused', TRAIN_BATCH x TRAIN_SEQ tokens of the
    synthetic stream per step: a Trainer of TRAIN_STEPS steps without
    checkpoints (launches per step, step time, tokens/s, peak memory);
    a second Trainer of TRAIN_CKPT_EVERY steps that saves its last step,
    and a third restored from that checkpoint running to TRAIN_STEPS: the
    second's and third's losses, and the third's final parameters, equal
    the first's bit for bit; a one-step trace; then TRAIN_BF16_STEPS bf16
    steps; then the third's final checkpoint restored into a fresh model,
    packed and served.  Each checkpoint save and restore is timed, and
    the checkpoints are removed however the phase ends."""
    print(f"== phase 24: training llama-7b-paper at full width, {TRAIN_LAYERS} layers, "
          f"\"precise\" through dsbp_fused, {TRAIN_BATCH} x {TRAIN_SEQ} tokens per step")
    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(dir=RUN_ROOT.parent, prefix="train_ckpt_"))
    try:
        rec = _train_run(torch, TM, Engine, ServeConfig, adamw, store, get_config, SyntheticLM,
                         DataConfig, Trainer, TrainConfig, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


def _train_run(torch, TM, Engine, ServeConfig, adamw, store, get_config, SyntheticLM,
               DataConfig, Trainer, TrainConfig, root: Path) -> dict:
    """The body of phase 24, its checkpoints under ``root``."""
    import numpy as np

    cfg = _train_cfg(get_config, TRAIN_LAYERS)
    ocfg = adamw.AdamWConfig(lr_peak=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    dcfg = DataConfig(seed=24, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    disk = shutil.disk_usage(root)
    print(f"  checkpoints under {root} ({disk.free / 2**30:.0f} GiB free)")
    remat = 2 if cfg.remat else 1
    want = {"dsbp_fused": 7 * TRAIN_LAYERS * remat, "flash_attention": TRAIN_LAYERS * remat}
    rec = {"layers": TRAIN_LAYERS, "tokens_per_step": TRAIN_BATCH * TRAIN_SEQ,
           "params": sum(p.numel() for p in TM.Model(cfg, "meta").parameters())}
    ckpt = {"save": [], "restore": []}
    ckpt_dir = root / "ckpt"

    def trainer(steps, ckpt_dir=""):
        return Trainer(cfg, TrainConfig(steps=steps, ckpt_dir=str(ckpt_dir) if ckpt_dir else "",
                                        ckpt_every=TRAIN_CKPT_EVERY, log_every=1, seed=24),
                       ocfg, dcfg, device="cuda")

    # the embedding gather's backward adds each token's row gradient into
    # the table with atomics (index_put_ with accumulate=True), in no fixed
    # order where a token repeats: deterministic algorithms make the
    # restarted run's sums, and so its losses, equal the first run's
    with _deterministic(torch) as nondet, _timed_store(store, ckpt):
        steps, per_step = [], []

        def log(step, m):
            now = _launch_counts(want)
            per_step.append({k: now[k] - log.last[k] for k in want})
            log.last = now
            steps.append(m["step_time_s"])

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        one = trainer(TRAIN_STEPS)
        log.last = _launch_counts(want)
        m1, s1, h1 = one.run(on_metrics=log)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        for i, got in enumerate(per_step):
            if got != want:
                raise AssertionError(f"24: step {i} launched {got}, want {want}")
        if not (np.isfinite(h1).all() and h1[-1] < h1[0]):
            raise AssertionError(f"24: losses {h1} (finite, the last below the first)")
        if peak > TRAIN_PEAK_GIB:
            raise AssertionError(f"24: peak {peak:.2f} GiB above {TRAIN_PEAK_GIB} GiB: the "
                                 f"phase must take the lock")
        ms = 1e3 * float(np.median(steps))
        print(f"  {TRAIN_STEPS} steps, no checkpoint: losses {[round(x, 4) for x in h1]}; "
              f"{ms:.1f} ms per step (median, the host's clock around each synchronized "
              f"step), {TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.0f} tokens/s; launches per step "
              f"{want} (remat: each layer's forward runs again in the backward); peak "
              f"{peak:.2f} GiB; {run_s:.1f} s with the model's init")
        final = {k: p.detach().to("cpu", copy=True) for k, p in m1.named_parameters()}
        del m1, s1, one
        gc.collect()
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m2, s2, h2 = trainer(TRAIN_CKPT_EVERY, ckpt_dir).run()
        del m2, s2
        gc.collect()
        torch.cuda.empty_cache()
        m3, s3, h3 = trainer(TRAIN_STEPS, ckpt_dir).run()
        restart_s = time.perf_counter() - t0
        if h2 + h3 != h1:
            raise AssertionError(f"24: the saving run's {h2} and the restored run's {h3} "
                                 f"losses != the uninterrupted run's {h1}")
        if not all(torch.equal(final[k], p.detach().cpu()) for k, p in m3.named_parameters()):
            raise AssertionError("24: the restarted run's parameters differ")
        print(f"  a run of {TRAIN_CKPT_EVERY} steps saving its last, and one restored from it "
              f"to step {TRAIN_STEPS}: losses {[round(x, 4) for x in h2]} + "
              f"{[round(x, 4) for x in h3]} equal the uninterrupted run's bit for bit, and "
              f"so are the final parameters; saves {[round(x, 1) for x in ckpt['save']]} s, "
              f"restore {[round(x, 1) for x in ckpt['restore']]} s of "
              f"{_dir_gib(ckpt_dir / f'step_{TRAIN_STEPS:08d}'):.2f} GiB each; "
              f"{restart_s:.1f} s for both runs")
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in SyntheticLM(dcfg, cfg).batch(TRAIN_STEPS).items()}
        t0 = time.perf_counter()
        trace, s3 = trace_train_step(torch, m3, s3, batch, ocfg)
        trace_s = time.perf_counter() - t0
        del m3, s3
        peak_restart = torch.cuda.max_memory_allocated() / 2**30
    print(f"  deterministic algorithms were on for the embedding gather's backward "
          f"(index_put_ with accumulate=True); ops with no deterministic form: "
          f"{nondet or 'none'}")
    gc.collect()
    torch.cuda.empty_cache()

    # bf16, as the JAX launcher trains at full size
    cfg16 = _train_cfg(get_config, TRAIN_LAYERS, dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m16, s16, h16 = Trainer(cfg16, TrainConfig(steps=TRAIN_BF16_STEPS, log_every=1000,
                                               seed=24),
                            adamw.AdamWConfig(lr_peak=3e-4, warmup_steps=2,
                                              total_steps=TRAIN_BF16_STEPS),
                            dcfg, device="cuda").run()
    del m16, s16
    peak16 = torch.cuda.max_memory_allocated() / 2**30
    bf16_s = time.perf_counter() - t0
    if not np.isfinite(h16).all():
        raise AssertionError(f"24: bf16 losses {h16}")
    if max(peak_restart, peak16) > TRAIN_PEAK_GIB:
        raise AssertionError(f"24: peak {peak_restart:.2f} GiB (restart) / {peak16:.2f} GiB "
                             f"(bf16) above {TRAIN_PEAK_GIB} GiB: the phase must take the lock")
    print(f"  bf16, {TRAIN_BF16_STEPS} steps: losses {[round(x, 4) for x in h16]}; peak "
          f"{peak16:.2f} GiB (the restart's runs and the trace: {peak_restart:.2f} GiB); "
          f"{bf16_s:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # the trained weights, restored into a fresh model, packed and served
    t0 = time.perf_counter()
    fresh = TM.Model(cfg, "cuda")
    like = {k: p for k, p in fresh.named_parameters()}
    t1 = time.perf_counter()
    (got, _), step = store.restore(str(ckpt_dir), (like, None))
    params_restore_s = time.perf_counter() - t1
    with torch.no_grad():
        for k, p in like.items():
            p.copy_(got[k])
    if step != TRAIN_STEPS or not all(torch.equal(final[k], p.cpu()) for k, p in like.items()):
        raise AssertionError(f"24: restored step {step} differs from the trained model")
    del got, final
    eng = Engine(fresh, ServeConfig(max_len=64), device="cuda")  # packs "precise"
    toks, lens = _prompts(cfg.vocab_size, [5, 17, 9, 12], seed=24)
    gen = eng.generate(toks, 8, lengths=lens)
    if gen.shape != (4, 8) or not ((gen >= 0) & (gen < cfg.vocab_size)).all():
        raise AssertionError(f"24: generate from the restored checkpoint gave {gen}")
    serve_s = time.perf_counter() - t0
    print(f"  step {step} restored (store.restore, the parameters alone: "
          f"{params_restore_s:.1f} s) into a fresh model, bit-equal to the trained one, packed "
          f"and served: {gen.tolist()}; {serve_s:.1f} s")
    del eng, fresh
    gc.collect()
    torch.cuda.empty_cache()
    rec.update(losses=h1, saved_run=h2, restored_run=h3, ms_per_step=ms, run_s=run_s,
               restart_s=restart_s, save_s=ckpt["save"], restore_s=ckpt["restore"],
               params_restore_s=params_restore_s, trace_s=trace_s, bf16_s=bf16_s,
               serve_s=serve_s, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / ms * 1e3, peak_gib=peak,
               peak_restart_gib=peak_restart,
               launches_per_step=want, trace=trace, bf16_losses=h16, bf16_peak_gib=peak16,
               served=gen.tolist())
    return rec


def train_phases(torch, Q, DF, FA, TO, TM, Engine, ServeConfig, get_config) -> dict:
    """Phase 24 whole: 24k, 24a and 24; prints one ``train (phase 24):``
    JSON line and returns the record."""
    from repro_torch.checkpoint import store
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    kern = phase_train_kernels(torch, Q, DF, FA, TO)
    cross = phase_train_cross_device(torch, TM, adamw, get_config, SyntheticLM, DataConfig)
    train = phase_train(torch, TM, Engine, ServeConfig, adamw, store, get_config, SyntheticLM,
                        DataConfig, Trainer, TrainConfig)
    rec = {"24k": kern, "24a": cross, "24": train, "seconds": time.perf_counter() - t0,
           "card": smi()}
    print("train (phase 24): " + json.dumps(rec, default=_jsonable))
    return rec


# ---------------------------------------------------------------------------
# phase 25: the eleventh config and the copied dense configs at full width
# on the card (yi-9b, phi3-medium-14b, deepseek-coder-33b at full depth,
# grok-1-314b at GROK_LAYERS layers), and the DCIM circuit models (25m)
# ---------------------------------------------------------------------------

# the copied dense configs, served at full width and depth
CONFIG_DENSE = ("yi-9b", "phi3-medium-14b", "deepseek-coder-33b")
# a whole run's split of phase 25's serves between its two processes, so
# their chains stay even: the first serves these, the second the others
CONFIG_FIRST = ("phi3-medium-14b", "deepseek-coder-33b")
# grok-1-314b's depth on one card: each layer is ~5.4 GB packed (its 8
# experts ~19.7 GB in f32 while the layer is drawn) beside the 6.4 GB f32
# embedding and head; 64 layers (~346 GB) wait for the expert axis (A13)
GROK_LAYERS = 4
# 25k: the config whose B1 decode shape is held at the prefill M too
# (M 512, the prefill tile of BN 128: every N here divides by it)
CONFIG_B1_PREFILL = {"yi-9b": (4096, 512), "phi3-medium-14b": (5120, 17920),
                     "deepseek-coder-33b": (7168, 19200), "grok-1-314b": (6144, 6144)}
# 25a: phi3-medium-14b (the most new shapes, Hkv 10) at full width and one
# layer, CPU (plain versions) vs card; the prompts stay short so the CPU's
# plain B1 (float64 group dots over 5,120 x 17,920 weights) takes seconds
CONFIG_CROSS_ARCH = "phi3-medium-14b"
CONFIG_CROSS_LENS = [12, 32, 5, 20]
CONFIG_CROSS_NEW = 6
# 25m: the circuit models' input at llama-7b's width, and the MPU's
# agreement with B3's float Eq. (1) bits (tests/test_macro_composition.py)
CIRCUIT_M, CIRCUIT_K = 512, 4096
CIRCUIT_AGREE = 0.9


def config_b1(cfg) -> list:
    """B1's (K, N, projections) in a decode step of ``cfg``: every
    projection of a dense layer; of an MoE layer the attention's alone
    (its expert stacks are weight-only, as in the reference)."""
    rows = frontend_b1(cfg)
    if cfg.n_experts:
        rows = [r for r in rows if not set(r[2].split()) & {"w1", "w3", "w2"}]
    return rows


def config_cfgs(get_config) -> dict:
    cfgs = {a: get_config(a).replace(quant="precise") for a in CONFIG_DENSE}
    cfgs["grok-1-314b"] = get_config("grok-1-314b").replace(quant="precise",
                                                             n_layers=GROK_LAYERS)
    return cfgs


def b1_timed_elsewhere(get_config) -> set:
    """B1's (K, N) that phases 2 (llama-7b's) and 22 (llava-next-34b's)
    hold against plain and time."""
    return set(LLAMA_SHAPES) | {(k, n) for k, n, _ in frontend_b1(get_config("llava-next-34b"))}


def phase_config_kernels(torch, Q, DF, FA, per_tensor_scale, get_config) -> dict:
    """25k: B1 at every (K, N) of the four configs that no earlier phase
    held against plain, at M 4, and one wide shape of each at M 512,
    bit-equal; B2 at their new head layouts (Hq : Hkv 48 : 8, 32 : 4, 40 :
    10; D 128), prefill and decode, within 1e-5 with head and row slices
    bit-equal; timed cold with their plain versions, SDPA and bounds."""
    print("== phase 25k: B1 and B2 at the shapes of yi-9b, phi3-medium-14b, "
          "deepseek-coder-33b and grok-1-314b")
    gen = torch.Generator(device="cuda").manual_seed(25)
    cfgs = config_cfgs(get_config)
    seen = b1_timed_elsewhere(get_config)
    b1 = []
    for arch, cfg in cfgs.items():
        for k, n, proj in config_b1(cfg):
            if (k, n) not in seen:
                seen.add((k, n))
                b1.append({**b1_case(torch, Q, DF, per_tensor_scale, gen, 4, k, n),
                           "arch": arch, "proj": proj})
        k, n = CONFIG_B1_PREFILL[arch]
        b1.append({**b1_case(torch, Q, DF, per_tensor_scale, gen, 512, k, n), "arch": arch,
                   "proj": next(p for kk, nn, p in config_b1(cfg) if (kk, nn) == (k, n))})
        torch.cuda.empty_cache()
    b2, heads = {}, {(32, 32), (32, 8), (56, 8)}  # phases 3 and 22 ran these
    for arch, cfg in cfgs.items():
        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        if (hq, hkv) in heads:
            continue
        heads.add((hq, hkv))
        b, s = 4, 512
        q = torch.randn(b, hq, s, d, generator=gen, device="cuda")
        k = torch.randn(b, hkv, s, d, generator=gen, device="cuda")
        v = torch.randn(b, hkv, s, d, generator=gen, device="cuda")
        for name, qq, kv_len, q0 in (
                ("prefill", q, [512, 300, 129, 77], [0, 0, 0, 0]),
                ("decode", q[:, :, :1].contiguous(), [512, 301, 129, 18], [511, 300, 128, 17])):
            b2[f"{arch} {name}"] = {**b2_case(torch, FA, f"{arch} {name}", qq, k, v, kv_len,
                                              q0), "Hq": hq, "Hkv": hkv}
        del q, k, v
        torch.cuda.empty_cache()
    return {"b1": b1, "b2": b2}


def phase_circuits(torch, Q, per_tensor_scale) -> dict:
    """25m: the DCIM circuit models (core.mpu, core.fiau, core.mac_array)
    on the card.  A seeded (512, 4,096) input, its group shifts from
    core.dsbp on the card: mpu_predict on the card equal to the CPU's,
    integer for integer, and within one level of B3's predicted bits on
    the same input under "precise", agreeing on >= CIRCUIT_AGREE of the
    groups; the FIAU's barrel_align of every mantissa at the MPU's widths
    equal to the CPU's and to align_group('trunc'); mac_array_matmul over
    those aligned mantissas at each weight width equal to the CPU's and to
    an integer matmul."""
    print("== phase 25m: the circuit models (MPU, FIAU, MAC array) on the card")
    from repro_torch.core import dsbp as D
    from repro_torch.core import fiau as FI
    from repro_torch.core import mac_array as MA
    from repro_torch.core import mpu as MPU
    from repro_torch.core.formats import decompose, get_format
    from repro_torch.kernels import fp8_quant_align as QA

    icfg = Q.PRESETS["precise"].input_cfg
    f = get_format(icfg.fmt)
    gen = torch.Generator(device="cuda").manual_seed(252)
    x = torch.randn(CIRCUIT_M, CIRCUIT_K, generator=gen, device="cuda") * torch.exp2(
        torch.randint(-4, 4, (CIRCUIT_M, CIRCUIT_K), generator=gen, device="cuda").float())
    xs = x * per_tensor_scale(x, f)
    k_fixed = int(icfg.k * (1 << MPU.MPU_KF))

    def path(t):  # the input path's fields, the MPU's widths, the FIAU's read
        d = decompose(t, f)
        sign, e, m = (D.group_reshape(d[key], 64) for key in ("sign", "e_unb", "m_int"))
        shift, e_max, nz = D.group_shifts(e, m)
        b = MPU.mpu_predict(shift, nz, k_fixed, icfg.b_fix)
        bw = b.clamp(*D.INPUT_WIDTH_RANGE)
        fiau = FI.barrel_align(sign * m, shift, f.mbits + 2, bw[..., None] + 1)
        a, _ = D.align_group(sign, m, f.mbits, shift, e_max, bw, "trunc")
        return shift, nz, b, fiau, a

    card, cpu = path(xs), path(xs.cpu())
    for name, got, want in zip(("shifts", "nonzeros", "MPU widths", "FIAU reads",
                                "align_group('trunc')"), card, cpu):
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"25m: {name} on the card differ from the CPU's")
    shift, nz, b, fiau, a = card
    if not torch.equal(fiau, a.long()):
        raise AssertionError("25m: the FIAU's reads differ from align_group('trunc')")
    mpu_ms = cuda_ms(lambda: MPU.mpu_predict(shift, nz, k_fixed, icfg.b_fix), [()], iters=10,
                     sleep=0)
    _, _, bits = QA.fp8_quant_align(xs, icfg)
    bw = b.clamp(*D.INPUT_WIDTH_RANGE)
    agree = float((bw == bits).float().mean())
    worst = int((bw - bits).abs().max())
    if worst > 1 or agree < CIRCUIT_AGREE:
        raise AssertionError(f"25m: the MPU's widths against B3's: {agree:.4f} agree (want >= "
                             f"{CIRCUIT_AGREE}), worst {worst} levels (want <= 1)")
    # the MAC array over the aligned input groups, one weight width each
    rows = {}
    for g, width in zip(range(0, 64, 16), (2, 4, 6, 8)):
        lim = 1 << (width - 1)
        w = torch.randint(-lim, lim, (64, 96), generator=gen, device="cuda", dtype=torch.int32)
        xg = a[:, g]
        got = MA.mac_array_matmul(xg, w, width)
        want = MA.mac_array_matmul(xg.cpu(), w.cpu(), width)
        exact = xg.cpu().long() @ w.cpu().long()
        if not (torch.equal(got.cpu(), want) and torch.equal(want.long(), exact)):
            raise AssertionError(f"25m: mac_array_matmul at width {width} differs from the CPU's "
                                 f"or from an integer matmul")
        rows[width] = cuda_ms(MA.mac_array_matmul, [(xg, w, width)], iters=10, sleep=0)
    print(f"  {CIRCUIT_M} x {CIRCUIT_K} input ({CIRCUIT_M * CIRCUIT_K // 64} groups): the MPU's "
          f"widths, the FIAU's reads and the MAC array's sums on the card equal the CPU's; "
          f"FIAU = align_group('trunc'); MPU vs B3's bits: {agree:.4f} agree, worst {worst} "
          f"level; mpu_predict {mpu_ms:.3f} ms, mac_array_matmul (512 x 64 x 96) by width "
          f"{ {w: round(ms, 4) for w, ms in rows.items()} } ms")
    return {"groups": CIRCUIT_M * CIRCUIT_K // 64, "mpu_vs_b3_agree": agree,
            "mpu_vs_b3_worst": worst, "mpu_ms": mpu_ms, "mac_array_ms_by_width": rows}


def phase_config_cross_device(torch, TM, Engine, ServeConfig, get_config) -> dict:
    """25a: phi3-medium-14b at full width and one layer, packed "precise"
    by init(pack=): a ragged generate on the CPU (plain versions) and the
    card (kernels), its sampled logits and tokens under phase 9's rule."""
    cfg = get_config(CONFIG_CROSS_ARCH).replace(quant="precise", n_layers=1)
    print(f"== phase 25a: {cfg.name} at full width, 1 layer, packed 'precise': CPU (plain) vs "
          f"card (kernels)")
    model = TM.init(cfg, seed=25, device="cuda", pack="precise")
    toks, lens = _prompts(cfg.vocab_size, CONFIG_CROSS_LENS, seed=25)
    scfg = ServeConfig(max_len=max(lens) + CONFIG_CROSS_NEW + 8, batch_size=len(lens))
    gpu = Engine(model, scfg, device="cuda")
    cpu = Engine(copy.deepcopy(gpu.model).to("cpu"), scfg, device="cpu")
    tapes, secs = [], []
    for eng in (cpu, gpu):
        tape = SampleTape(eng, cfg.vocab_size)
        t0 = time.perf_counter()
        out = eng.generate(toks, CONFIG_CROSS_NEW, lengths=lens)
        secs.append(time.perf_counter() - t0)
        tapes.append(tape.close())
    at, equal, worst = check_calls(torch, *tapes)
    if out.shape != (len(lens), CONFIG_CROSS_NEW):
        raise AssertionError(f"25a: generate gave {out.shape}")
    print(f"  generate (lens {lens.tolist()}, {CONFIG_CROSS_NEW} new; CPU {secs[0]:.1f} s, card "
          f"{secs[1]:.1f} s): logits within {worst:.2e} of max|logit| (limit {KV_TIE}), "
          f"{equal} of {len(tapes[0])} batches bit-equal, "
          + ("every token equal" if at is None else f"near tie at batch {at}")
          + f": {out.tolist()}")
    del cpu, gpu, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "n_layers": 1, "max_rel_logit_diff": worst,
            "equal_batches": equal, "near_tie_batch": at, "cpu_s": secs[0], "card_s": secs[1]}


def phase_config(torch, TM, Engine, ServeConfig, Request, TO, kernels, cfg) -> dict:
    """25: one config at full width (full depth, or grok's GROK_LAYERS),
    drawn and packed one layer at a time ("precise"), f32, max_len 512:
    phase 5's traffic through generate and a dense serve, each kernel's
    launches counted in every decode step (B1 by (K, N) against the
    containers), the init's and the runs' peaks gated; an MoE config's FFN
    of one decode step and its expert dequantizes timed."""
    print(f"== phase 25: {cfg.name} at full width, {cfg.n_layers} layers (~"
          f"{cfg.param_count() / 1e9:.2f}e9 parameters), init(pack=): generate + dense serve "
          f"of phase 5's traffic")
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):  # seconds per part of the phase, for its time budget
        torch.cuda.synchronize()
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 2)
        t_lap[0] = now

    model, init = packed_init(torch, TM, cfg, lap)
    max_len, n = 512, cfg.n_layers
    eng = Engine(model, ServeConfig(max_len=max_len, batch_size=4), device="cuda")
    if eng.pack_report is not None or eng.cfg.quant_method != "dsbp_fused":
        raise AssertionError("the engine repacked a packed model")
    toks, lens, reqs = _serve_traffic(Request, cfg.vocab_size)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- this config's path: counts from 0 over exactly these two runs ----
    _reset_launches(kernels)
    counter = StepCounter(eng, kernels, TO)
    try:
        out = eng.generate(toks, 16, lengths=lens)
        gst = dict(eng.last_stats)
        served = eng.serve(reqs, max_new_tokens=16)
        sst = dict(eng.last_stats)
    finally:
        steps, _, _ = counter.close()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    lap("generate + serve")
    if out.shape != (4, 16) or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"{cfg.name}: generate output {out.shape} out of range")
    if sorted(served) != list(range(8)) or any(len(t) != 16 for t in served.values()):
        raise AssertionError(f"{cfg.name}: serve did not return 16 tokens for each of 8 requests")
    with torch.inference_mode():
        lg, _, _ = eng.model.prefill(torch.as_tensor(toks, device="cuda"), max_len,
                                     lengths=lens, quant=eng.quant)
    if not torch.isfinite(lg).all():
        raise AssertionError(f"{cfg.name}: prefill logits are not finite")
    del lg
    for name in ("dsbp_fused", "flash_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {cfg.name} path")
    want_b1 = {(k, nn): n * len(proj.split()) for k, nn, proj in config_b1(cfg)}
    if len(steps) != gst["decode_steps"] + sst["decode_steps"]:
        raise AssertionError(f"{cfg.name}: {len(steps)} decode steps counted, the runs took "
                             f"{gst['decode_steps']} + {sst['decode_steps']}")
    step = _per_step([c for c, _ in steps], cfg.name)
    shapes = _per_step([sh for _, sh in steps], f"{cfg.name} B1 by (K, N)")
    want = {"dsbp_fused": sum(want_b1.values()), "flash_attention": n}
    if step != want or shapes != want_b1 or _b1_shapes(model) != want_b1:
        raise AssertionError(f"{cfg.name}: a decode step launched {step}, B1 by (K, N) {shapes}; "
                             f"want {want}, {want_b1} (the containers give "
                             f"{_b1_shapes(model)})")
    limit, _ = runs_peak_limit(cfg, init, 4, max_len, int(max(lens)))
    if peak > limit:
        raise AssertionError(f"{cfg.name}: peak {peak / 1e9:.2f} GB above packed + two f32 "
                             f"layers + the cache + the prefill's K/V and activations "
                             f"({limit / 1e9:.2f} GB)")
    lap("gates")
    res = {"n_layers": n, "params": cfg.param_count(), "init_s": laps["init(pack=)"], **init,
           "launches": launches, "step_launches": step,
           "b1_by_shape": {f"K={k} N={nn}": c for (k, nn), c in shapes.items()},
           "decode_steps_counted": len(steps), "peak": peak, "peak_limit": limit,
           "prefill_s": gst["prefill_s"], "decode_ms": 1e3 * gst["decode_s"] / gst["decode_steps"],
           "decode_tps": gst["decode_tokens"] / gst["decode_s"],
           "serve_prefill_s": sst["prefill_time_s"],
           "serve_ms": 1e3 * sst["decode_time_s"] / sst["decode_steps"],
           "serve_tps": sst["decode_tps"], "serve_steps": sst["decode_steps"]}
    print(f"  generate: 4 prompts (lens {lens.tolist()}), 16 new: prefill "
          f"{res['prefill_s']:.3f} s, {res['decode_ms']:.2f} ms per decode step, "
          f"{res['decode_tps']:.1f} tok/s; serve: 8 requests through 4 slots: "
          f"{sst['decode_steps']} steps, prefill {res['serve_prefill_s']:.3f} s, "
          f"{res['serve_ms']:.2f} ms/step, {res['serve_tps']:.1f} tok/s")
    print(f"  every one of {len(steps)} decode steps launched {step}, B1 by (K, N) "
          f"{res['b1_by_shape']}; launches over both runs {launches}; peak "
          f"{peak / 2**30:.2f} GiB (limit {limit / 2**30:.2f} GiB)")
    if cfg.n_experts:  # the MoE FFN of one decode step (4 rows), as phase 20
        res.update(moe_step_times(torch, model, cfg))
        lap("MoE FFN timed")
        print(f"  the MoE FFN of one decode step ({n} layers, 4 rows, top-{cfg.top_k} of "
              f"{cfg.n_experts}): {res['moe_ffn_ms_step']:.2f} ms on the device, of it the "
              f"{3 * n} expert-stack dequantizes {res['dequantize_ms_step']:.2f} ms "
              f"({res['dequantize_bytes_step'] / 1e9:.1f} GB read + written: bound "
              f"{1e3 * res['dequantize_bytes_step'] / HBM_BPS:.2f} ms)")
    res["seconds_by_part"] = laps
    print(f"  seconds by part: {laps}")
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def config_serves(torch, TM, Engine, ServeConfig, Request, DF, FA, TO, get_config,
                  archs) -> dict:
    """Phase 25 for each of ``archs`` in turn, each model freed before the next."""
    kernels = {"dsbp_fused": DF.dsbp_fused, "flash_attention": FA.flash_attention}
    cfgs = config_cfgs(get_config)
    return {a: phase_config(torch, TM, Engine, ServeConfig, Request, TO, kernels, cfgs[a])
            for a in archs}


def config_kernels(torch, Q, DF, FA, per_tensor_scale, get_config) -> dict:
    """25k and 25m: the phase's kernel and circuit timings, alone on the card."""
    return {"25k": phase_config_kernels(torch, Q, DF, FA, per_tensor_scale, get_config),
            "25m": phase_circuits(torch, Q, per_tensor_scale)}


def config_record(card: str, kern: dict, cross: dict, serves: dict, get_config) -> dict:
    """Phase 25's record: every B1 shape a served config launched was timed
    (here, or by phases 2 and 22), 25k's rows carry their launches per
    decode step; prints one ``configs (phase 25):`` JSON line."""
    timed = {f"K={k} N={n}" for k, n in b1_timed_elsewhere(get_config)}
    for x in kern["25k"]["b1"]:
        timed.add(f"K={x['K']} N={x['N']}")
        if x["M"] == 4:
            x["launches_per_step"] = serves[x["arch"]]["b1_by_shape"][f"K={x['K']} N={x['N']}"]
            x["launches_of"] = f"one decode step, phase 25, {x['arch']}"
    for arch, r in serves.items():
        missing = set(r["b1_by_shape"]) - timed
        if missing:
            raise AssertionError(f"{arch}: B1 launched at {sorted(missing)}, timed nowhere")
    for key, x in kern["25k"]["b2"].items():
        x["launches_per_step"] = serves[key.split()[0]]["step_launches"]["flash_attention"]
    rec = {"card": card, "kernels": kern["25k"], "25m": kern["25m"], "25a": cross, **serves}
    print("configs (phase 25): " + json.dumps(rec, default=_jsonable))
    return rec


# ---------------------------------------------------------------------------
# phase 26: training beyond the dense family (the hybrid, MoE, SSD and the
# two frontends) at full width
# ---------------------------------------------------------------------------

# (depth, batch, text positions per row) of phase 26's Trainers: full
# width, f32, "precise" through dsbp_fused, remat, the synthetic stream.
# The depth is cut to what a train state of 16 bytes per parameter
# (weights, gradients, m, v) leaves beside the other process:
# recurrentgemma-2b one (rglru, rglru, attn_local) unit beside its tied
# 0.66e9-parameter embedding (~15 GB, and (4 x 512) x 256,000 f32 logits);
# mixtral-8x7b one layer (~1.67e9 parameters, ~27 GB); mamba2-370m whole;
# musicgen-large 4 layers; llava-next-34b one layer (~1.48e9, ~24 GB) at
# batch 1, whose row is 2,880 image positions + 128 text: the attention
# backward (the plain version's) holds (B, 56, 3,008, 3,008) f32 scores,
# 2.0 GB a row, three or four times
FAMILY_TRAIN = {"recurrentgemma-2b": (3, 4, 512), "mixtral-8x7b": (1, 4, 512),
                "mamba2-370m": (48, 4, 512), "musicgen-large": (4, 4, 512),
                "llava-next-34b": (1, 1, 128)}
# above ~25 GiB, they take the lock: recurrentgemma-2b's 4 x 512 x 256,000
# f32 logits and their softmax's backward beside its train state peaked at
# 34.17 GiB on an H100
FAMILY_HEAVY = ("recurrentgemma-2b", "mixtral-8x7b", "llava-next-34b")
# a whole run's split of phase 26 between its two processes, so their
# chains stay even (861 s / 801 s on an H100 with musicgen-large's Trainer
# and mixtral's and musicgen's 26a in the first): the first trains these
# (under the lock) and runs 26a of FAMILY_CROSS_FIRST (llava's takes ~65 s
# of the CPU), the second the others (its heavy Trainers under the lock)
FAMILY_FIRST = ("mixtral-8x7b", "llava-next-34b")
FAMILY_CROSS_FIRST = ("llava-next-34b",)
# a heavy Trainer's peak: the card's 74.5 GiB less the other process's
# phases (at most TRAIN_PEAK_GIB while this one holds the lock) and room
FAMILY_HEAVY_GIB = 48.0
FAMILY_STEPS, FAMILY_LR = 5, 3e-4
# the restarted run (saving at this step, restored from it to the end)
# and the bf16 steps
FAMILY_RESTART = ("mamba2-370m", 3)
FAMILY_BF16 = ("mamba2-370m", 2)
# each family's product that only it has (the projection of that weight
# shape), by (name, K, N): 26k holds B1's straight-through product there
# at the phase's rows, 26a plants its faults there
FAMILY_SHAPE = {"recurrentgemma-2b": ("w2", 7680, 2560), "mixtral-8x7b": ("wk/wv", 4096, 1024),
                "mamba2-370m": ("w_out", 2048, 1024), "musicgen-large": ("w2", 8192, 2048),
                "llava-next-34b": ("w2", 20480, 7168)}
# 26k: B2's autograd function at the families' head layouts (arch, B, Hq,
# Hkv, S, D, window): recurrentgemma-2b's MQA past its 2,048-key window,
# mixtral-8x7b's GQA 32 : 8 under its 4,096 window, musicgen-large's MHA at
# D 64, llava-next-34b's GQA 56 : 8 over one row of 2,880 image + 128 text
# positions
FAMILY_B2 = (("recurrentgemma-2b", 2, 10, 1, 2560, 256, 2048),
             ("mixtral-8x7b", 4, 32, 8, 512, 128, 4096),
             ("musicgen-large", 4, 32, 32, 512, 64, 0),
             ("llava-next-34b", 1, 56, 8, 3008, 128, 0))
# 26a: CPU vs card, one step of TRAIN_CROSS_BATCH x TRAIN_CROSS_SEQ tokens
# at one layer (the hybrid one unit), llava-next-34b's image prefix cut
# to FAMILY_CROSS_IMAGE positions (the CPU's plain versions set the pace)
FAMILY_CROSS_IMAGE = 64
# 26a's "precise" gradient limit (card vs CPU, relative norm), 24a's
# TRAIN_GRAD_REL but for recurrentgemma-2b, whose random-weight layers are
# FP8-sensitive (ROADMAP C): at full width and one (rglru, rglru,
# attn_local) unit the card's own step from weights one ulp away moved a
# gradient by 0.101 of its norm (wq), the planted faults by 0.78-1.1 (an
# H100, PERF.md, PR 27), so its limit is HYBRID_TIE, as phase 19's is
FAMILY_GRAD_REL = {"recurrentgemma-2b": HYBRID_TIE}
# 26a's float gradient limit, 24a's TRAIN_FLOAT_REL but for mamba2-370m:
# the gradient of an SSD layer's a_log (H values) sums the decay's chain
# over every row, position, head dim and state (~2^20 f32 terms a head
# at 2 x 64 tokens, 2^-24 * sqrt(n) ~ 6e-5), which the card and the CPU
# sum in other orders: 1.54e-5 of its norm on an H100 (PERF.md, PR 27)
FAMILY_FLOAT_REL = {"mamba2-370m": 1e-4}


def family_cfg(get_config, arch: str, n_layers: int, dtype: str = "float32"):
    return get_config(arch).replace(n_layers=n_layers, quant="precise",
                                    quant_method="dsbp_fused", dtype=dtype)


def family_launches(model, remat: int) -> dict:
    """B1 and B2 launches of one train step of ``model`` (each layer's
    forward ``remat`` times): every quantized projection of a layer (an
    attention layer's wq wk wv wo and, without experts, w1 w3 w2; an
    rglru layer's w_in w_gate w_out and its FFN; an ssd layer's w_in
    w_out), one attention per attention layer."""
    per_kind = {"rglru": 6, "ssd": 2}
    b1 = sum(per_kind.get(layer.kind, 4 if model.cfg.n_experts else 7)
             for layer in model.layers)
    b2 = sum(layer.has_kv for layer in model.layers)
    return {"dsbp_fused": remat * b1, "flash_attention": remat * b2}


def phase_family_kernels(torch, Q, DF, FA, TO, per_tensor_scale, get_config) -> dict:
    """26k: B2's autograd function at FAMILY_B2's head layouts (output and
    q / k / v gradients within 1e-5 of the plain version's autograd; the
    forward timed cold beside plain and SDPA, forward + backward beside
    SDPA's) and 'dsbp_fused''s straight-through product at each family's
    FAMILY_SHAPE at phase 26's rows (forward bit-equal to its plain
    version, gx / gw to the f32 products; B1 timed cold there)."""
    print("== phase 26k: the training Functions at the families' shapes: B2's gradient, "
          "dsbp_fused's straight-through product")
    gen = torch.Generator(device="cuda").manual_seed(26)
    out = {"b2": {}, "b1": []}
    for arch, b, hq, hkv, s, d, window in FAMILY_B2:
        q = torch.randn(b, hq, s, d, generator=gen, device="cuda")
        k, v = (torch.randn(b, hkv, s, d, generator=gen, device="cuda") for _ in range(2))
        g = torch.randn(b, hq, s, d, generator=gen, device="cuda")
        kv_len = torch.full((b,), s, dtype=torch.int32, device="cuda")
        q0 = torch.zeros(b, dtype=torch.int32, device="cuda")
        rel = b2_grad_case(torch, FA, q, k, v, kv_len, q0, g, window=window)
        row = b2_case(torch, FA, f"{arch} training", q, k, v, kv_len.tolist(), q0.tolist(),
                      window=window)
        mask = FA.attention_mask(kv_len, q0, s, s, causal=True, window=window)[:, None]

        def step(fn, *a):
            qkv = [t.requires_grad_(True) for t in a[:3]]
            torch.autograd.grad(fn(*qkv, *a[3:]), qkv, g)

        kern = functools.partial(FA.flash_attention_grad, causal=True, window=window)
        grad_ms = cuda_ms(lambda *a: step(kern, *a), [(q, k, v, kv_len, q0)], iters=3, warmup=1)
        lib_grad_ms = cuda_ms(lambda *a: step(_sdpa, *a), [(q, k, v, mask)], iters=3, warmup=1)
        row.update(arch=arch, shape=f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} window={window}",
                   rel_out_dq_dk_dv=rel, grad_ms=grad_ms, library_grad_ms=lib_grad_ms)
        print(f"  B2 {arch}: output, dq, dk, dv within {['%.2e' % r for r in rel]} of the "
              f"plain version's autograd (limit 1e-5); forward + backward {grad_ms:.3f} ms "
              f"(the backward the plain version's), SDPA's {lib_grad_ms:.3f} ms")
        out["b2"][arch] = row
        del q, k, v, g, mask
        torch.cuda.empty_cache()
    cfg = Q.PRESETS["precise"]
    for arch, (_, kk, n) in FAMILY_SHAPE.items():
        _, b, s = FAMILY_TRAIN[arch]
        m = b * (s + get_config(arch).n_image_tokens)
        ste = ste_case(torch, "dsbp_fused", TO.dsbp_matmul_fused_ste, fused_plain,
                       ("dsbp_fused",), gen, cfg, m, kk, n)
        row = b1_case(torch, Q, DF, per_tensor_scale, gen, m, kk, n, plain_rows=PLAIN_ROWS)
        out["b1"].append({**row, "arch": arch, "ste": ste})
        torch.cuda.empty_cache()
    return out


def _route_log(torch):
    """Records each MoE layer's chosen experts (``moe.route``'s idx) while
    the block runs: (context manager, the list it fills)."""
    from repro_torch.models import moe as MOE

    seen = []

    @contextlib.contextmanager
    def recording():
        orig = MOE.route

        def route(*a, **kw):
            out = orig(*a, **kw)
            seen.append(out[0].detach().to("cpu"))
            return out

        MOE.route = route
        try:
            yield
        finally:
            MOE.route = orig

    return recording, seen


def phase_family_cross_device(torch, TM, adamw, get_config, SyntheticLM, DataConfig,
                              archs) -> dict:
    """26a: each family at full width and one layer (recurrentgemma-2b
    one pattern unit; llava-next-34b with FAMILY_CROSS_IMAGE image
    positions), one train step of TRAIN_CROSS_BATCH x TRAIN_CROSS_SEQ
    tokens on the CPU (plain versions) and the card (kernels) from the
    same weights and batch, float then "precise" through 'dsbp_fused', by
    24a's rule (norms relative to the card's gradients): float gradients
    within FAMILY_FLOAT_REL (TRAIN_FLOAT_REL but for the SSD);
    "precise" losses within phase 9's bound and gradients within
    FAMILY_GRAD_REL (TRAIN_GRAD_REL but for the hybrid), which must lie
    above the card's own step from weights one ulp away and below three
    planted faults (B1's K loop one group
    short, and on the family's own FAMILY_SHAPE product its output x2 and
    its weight gradient lost), read in every run.  MoE routes that differ
    between the two sides are counted."""
    print(f"== phase 26a: the families at full width, one layer (unit), one train step: "
          f"CPU (plain) vs card (kernels)")
    from repro_torch.core.quantized import STEProduct
    from repro_torch.kernels import ops as TO
    from repro_torch.models.layers import Quant

    out, failed = {}, []
    for arch in archs:
        target = FAMILY_SHAPE[arch]
        t_arch = time.perf_counter()
        layers = 3 if arch == "recurrentgemma-2b" else 1
        cfg = family_cfg(get_config, arch, layers).replace(remat=False)
        if cfg.frontend == "vlm_patches":
            cfg = cfg.replace(n_image_tokens=FAMILY_CROSS_IMAGE)
        batch = SyntheticLM(DataConfig(seed=26, batch_size=TRAIN_CROSS_BATCH,
                                       seq_len=TRAIN_CROSS_SEQ), cfg).batch(0)
        gpu_model = TM.init(cfg, seed=26, device="cuda")
        cpu_model = TM.Model(cfg, torch.device("cpu"))
        with torch.no_grad():
            for p, c in zip(gpu_model.parameters(), cpu_model.parameters()):
                c.copy_(p)
        want = family_launches(gpu_model, 1)
        out[arch] = {}
        for label, quant, limit in (("float", Quant(None),
                                     FAMILY_FLOAT_REL.get(arch, TRAIN_FLOAT_REL)),
                                    ("precise", Quant("precise", "dsbp_fused"),
                                     FAMILY_GRAD_REL.get(arch, TRAIN_GRAD_REL))):
            recording, routes = _route_log(torch)
            counts = _launch_counts(want)
            with recording():
                gl, gg = _loss_and_grads(torch, TM, adamw, gpu_model, batch, quant)
            launched = {k: c - counts[k] for k, c in _launch_counts(want).items()}
            if launched != (want if quant else {**want, "dsbp_fused": 0}):
                raise AssertionError(f"26a {arch} {label}: launches {launched}, want {want}")
            rec = {}
            if quant:
                # both sides of the limit, on the card: weights one ulp
                # away (put back from the CPU's copy), planted faults
                with torch.no_grad():
                    for p in gpu_model.parameters():
                        p.copy_(torch.nextafter(p, torch.full_like(p, math.inf)))
                nl, ng_ = _loss_and_grads(torch, TM, adamw, gpu_model, batch, quant)
                with torch.no_grad():
                    for p, c in zip(gpu_model.parameters(), cpu_model.parameters()):
                        p.copy_(c)
                rec["one ulp"] = (abs(nl - gl) / abs(gl), _grad_rels(torch, ng_, gg)[:2])
                del ng_
                for name, fault in _train_faults(torch, TO, STEProduct, *target).items():
                    with _fused_ste_as(TO, fault):
                        fl, fg = _loss_and_grads(torch, TM, adamw, gpu_model, batch, quant)
                    rec[name] = (abs(fl - gl) / abs(gl), _grad_rels(torch, fg, gg)[:2])
                    del fg
            card_routes = list(routes)
            routes.clear()
            with recording():
                cl, cg = _loss_and_grads(torch, TM, adamw, cpu_model, batch, quant)
            flips = sum(int((a != b).sum()) for a, b in zip(card_routes, routes))
            rel_loss = abs(gl - cl) / abs(cl)
            rels = _grad_rels(torch, cg, gg)  # on the card: float64 sums of 1.5e9 terms
            print(f"  {arch} ({layers} layer(s)) {label}: loss card {gl:.6f}, CPU {cl:.6f} "
                  f"(relative {rel_loss:.2e}, limit {KV_TIE}); gradients within "
                  f"{rels[0][0]:.2e} of the card's norm (limit {limit}; largest "
                  f"{[(k, float('%.2e' % r)) for r, k in rels[:3]]}); launched {launched}"
                  + (f"; MoE choices that differ between the sides: {flips} of "
                     f"{sum(r.numel() for r in routes)}" if cfg.n_experts else ""))
            # every family's readings first, then the verdict
            if not (math.isfinite(gl) and rel_loss <= KV_TIE):
                failed.append(f"26a {arch} {label}: loss card {gl} vs CPU {cl}")
            if not rels[0][0] <= limit:
                failed.append(f"26a {arch} {label}: gradient of {rels[0][1]} card vs CPU "
                              f"{rels[0][0]} > {limit}")
            out[arch][label] = {"loss_card": gl, "loss_cpu": cl, "rel_loss": rel_loss,
                                "worst_grads": rels[:3], "launches": launched,
                                "route_flips": flips}
            if quant:
                for name, (lr, worst) in rec.items():
                    print(f"    card vs card, {name}: loss {lr:.2e} apart, gradients "
                          f"{[(k, float('%.2e' % r)) for r, k in worst]}")
                noise = max(rels[0][0], rec["one ulp"][1][0][0])
                caught = min(r[1][0][0] for n, r in rec.items() if n != "one ulp")
                if not noise <= limit < caught:
                    failed.append(f"26a {arch}: the QAT limit {limit} does not separate "
                                  f"last-bit noise ({noise:.2e}) from the planted faults "
                                  f"({caught:.2e})")
                out[arch][label]["readings"] = rec
            del gg, cg
        out[arch]["seconds"] = time.perf_counter() - t_arch
        print(f"    {arch}: {out[arch]['seconds']:.1f} s")
        del cpu_model, gpu_model
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return out


@contextlib.contextmanager
def _deterministic(torch):
    """Deterministic algorithms for the block (the embedding gather's
    backward adds rows with atomics, in no fixed order where a token
    repeats); yields the list of ops warned about as having no
    deterministic form."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    nondet = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield nondet
        nondet.extend(sorted({str(w.message).split(".")[0] for w in caught
                              if "deterministic" in str(w.message)}))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = True


def family_train(torch, TM, adamw, store, get_config, SyntheticLM, DataConfig, Trainer,
                 TrainConfig, arch: str) -> dict:
    """26 for one config: a Trainer of FAMILY_STEPS steps at
    FAMILY_TRAIN's depth and batch (the losses finite, B1 and B2
    launches per step as ``family_launches`` counts them under remat, ms
    per step, tokens/s, a held-out batch's loss lower after the last step
    than before the first, peak memory gated below TRAIN_PEAK_GIB, or
    FAMILY_HEAVY_GIB under the lock); for FAMILY_RESTART's config the run
    saves at its step and the end, and a second run restored from that
    step reaches the same losses and parameters bit for bit (deterministic
    algorithms on for both); for FAMILY_BF16's, its bf16 steps (finite,
    peak)."""
    import numpy as np

    layers, b, s = FAMILY_TRAIN[arch]
    cfg = family_cfg(get_config, arch, layers)
    ocfg = adamw.AdamWConfig(lr_peak=FAMILY_LR, warmup_steps=2, total_steps=FAMILY_STEPS)
    dcfg = DataConfig(seed=26, batch_size=b, seq_len=s)
    restart_at = FAMILY_RESTART[1] if arch == FAMILY_RESTART[0] else None
    gate = FAMILY_HEAVY_GIB if arch in FAMILY_HEAVY else TRAIN_PEAK_GIB
    positions = b * (s + cfg.n_image_tokens)
    print(f"  {arch}: {layers} of {get_config(arch).n_layers} layers, {b} x {s} tokens"
          + (f" after {cfg.n_image_tokens} image positions" if cfg.n_image_tokens else "")
          + f" per step, {FAMILY_STEPS} steps")
    root = Path(tempfile.mkdtemp(dir=RUN_ROOT.parent, prefix="family_ckpt_"))
    rec = {"layers": layers, "batch": b, "seq": s, "positions_per_step": positions,
           "params": sum(p.numel() for p in TM.Model(cfg, "meta").parameters())}
    try:
        def trainer(ckpt="", model=None):
            return Trainer(cfg, TrainConfig(steps=FAMILY_STEPS, ckpt_dir=str(ckpt),
                                            ckpt_every=restart_at or FAMILY_STEPS, log_every=1,
                                            seed=26), ocfg, dcfg, model=model, device="cuda")

        def held_out_loss(model):  # a batch no step trains on
            batch = {k: torch.as_tensor(v, device="cuda")
                     for k, v in SyntheticLM(dcfg, cfg).batch(FAMILY_STEPS).items()}
            with torch.no_grad():
                return float(TM.loss_fn(model, batch)[0])

        steps, per_step, want = [], [], {}

        def log(step, m):
            now = _launch_counts(("dsbp_fused", "flash_attention"))
            per_step.append({k: now[k] - log.last[k] for k in now})
            log.last = now
            steps.append(m["step_time_s"])

        det = _deterministic(torch) if restart_at else contextlib.nullcontext([])
        ckpt = root / "ckpt" if restart_at else ""
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with det as nondet:
            model = TM.init(cfg, seed=26, device="cuda")
            before = held_out_loss(model)
            tr = trainer(ckpt, model)
            log.last = _launch_counts(("dsbp_fused", "flash_attention"))
            model, opt, hist = tr.run(on_metrics=log)
            run_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            want = family_launches(model, 2 if cfg.remat else 1)
            after = held_out_loss(model)
            if restart_at:
                final = {k: p.detach().to("cpu", copy=True) for k, p in model.named_parameters()}
                del model, opt, tr
                gc.collect()
                shutil.rmtree(ckpt / f"step_{FAMILY_STEPS:08d}")
                t1 = time.perf_counter()
                m2, _, h2 = trainer(ckpt).run()
                rec["restart_s"] = time.perf_counter() - t1
                if h2 != hist[restart_at:]:
                    raise AssertionError(f"26 {arch}: the restored run's losses {h2} != "
                                         f"{hist[restart_at:]}")
                if not all(torch.equal(final[k], p.detach().cpu())
                           for k, p in m2.named_parameters()):
                    raise AssertionError(f"26 {arch}: the restored run's parameters differ")
                del m2, final
                rec["restored_losses"] = h2
            else:
                del model, opt, tr
        if restart_at:
            print(f"    saved at step {restart_at}, a run restored from it reaches the same "
                  f"losses {[round(x, 4) for x in rec['restored_losses']]} and parameters bit "
                  f"for bit ({rec['restart_s']:.1f} s, restore included; deterministic "
                  f"algorithms on, no deterministic form for {nondet or 'no op'})")
        for i, got in enumerate(per_step):
            if got != want:
                raise AssertionError(f"26 {arch}: step {i} launched {got}, want {want}")
        # each step draws another batch, whose loss moves by about as much
        # as a few steps of learning: the gate reads one held-out batch
        # before the first step and after the last
        if not (np.isfinite(hist).all() and after < before):
            raise AssertionError(f"26 {arch}: losses {hist}; a held-out batch's {before} before "
                                 f"and {after} after (finite, falling)")
        if peak > gate:
            raise AssertionError(f"26 {arch}: peak {peak:.2f} GiB above its gate {gate} GiB")
        ms = 1e3 * float(np.median(steps))
        print(f"    losses {[round(x, 4) for x in hist]}; a held-out batch's {before:.4f} "
              f"before, {after:.4f} after; {ms:.1f} ms per step (median, the "
              f"host's clock around each synchronized step), {b * s / ms * 1e3:.0f} tokens/s "
              f"({positions / ms * 1e3:.0f} positions/s); launches per step {want} (remat); "
              f"peak {peak:.2f} GiB (gate {gate}); {run_s:.1f} s with the model's init")
        rec.update(losses=hist, held_out=(before, after), ms_per_step=ms,
                   tokens_per_s=b * s / ms * 1e3,
                   positions_per_s=positions / ms * 1e3, launches_per_step=want,
                   peak_gib=peak, peak_gate_gib=gate, run_s=run_s)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    if arch == FAMILY_BF16[0]:
        cfg16 = family_cfg(get_config, arch, layers, dtype="bfloat16")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m16, s16, h16 = Trainer(cfg16, TrainConfig(steps=FAMILY_BF16[1], log_every=1000,
                                                   seed=26),
                                adamw.AdamWConfig(lr_peak=FAMILY_LR, warmup_steps=1,
                                                  total_steps=FAMILY_BF16[1]),
                                dcfg, device="cuda").run()
        del m16, s16
        peak16 = torch.cuda.max_memory_allocated() / 2**30
        if not np.isfinite(h16).all() or peak16 > gate:
            raise AssertionError(f"26 {arch} bf16: losses {h16}, peak {peak16:.2f} GiB")
        print(f"    bf16, {FAMILY_BF16[1]} steps: losses {[round(x, 4) for x in h16]}; peak "
              f"{peak16:.2f} GiB; {time.perf_counter() - t0:.1f} s")
        rec.update(bf16_losses=h16, bf16_peak_gib=peak16)
        gc.collect()
        torch.cuda.empty_cache()
    return rec


def family_trains(torch, TM, get_config, archs) -> dict:
    """26 for ``archs``, in order: {arch: record}."""
    if not archs:
        return {}
    from repro_torch.checkpoint import store
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import TrainConfig, Trainer

    print(f"== phase 26: training {', '.join(archs)} at full width, \"precise\" through "
          f"dsbp_fused, remat")
    out, failed = {}, []
    for arch in archs:  # every config's readings first, then the verdict
        t0 = time.perf_counter()
        try:
            out[arch] = family_train(torch, TM, adamw, store, get_config, SyntheticLM,
                                     DataConfig, Trainer, TrainConfig, arch)
        except AssertionError as e:
            print(f"    FAILED: {e}")
            failed.append(str(e))
            gc.collect()
            torch.cuda.empty_cache()
            continue
        out[arch]["seconds"] = time.perf_counter() - t0
        print(f"    {arch}: {out[arch]['seconds']:.1f} s")
    if failed:
        raise AssertionError("; ".join(failed))
    return out


def family_cross(torch, TM, get_config, archs) -> dict:
    """26a for ``archs``, in order: {arch: record}."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw

    return phase_family_cross_device(torch, TM, adamw, get_config, SyntheticLM, DataConfig,
                                     archs)


def family_record(card: str, kern: dict, cross: dict, trains: dict) -> dict:
    """Phase 26's record, its kernel rows with the launches per step of
    the Trainer of their config; prints one ``train-families (phase 26):``
    JSON line."""
    for row in kern["b1"]:
        row["launches_per_step"] = trains[row["arch"]]["launches_per_step"]["dsbp_fused"]
    for arch, row in kern["b2"].items():
        row["launches_per_step"] = trains[arch]["launches_per_step"]["flash_attention"]
    rec = {"card": card, "26k": kern, "26a": cross, "26": trains}
    print("train-families (phase 26): " + json.dumps(rec, default=_jsonable))
    return rec


def family_kernels(torch, Q, DF, FA, KVQ, TO, per_tensor_scale, get_config) -> dict:
    """The kernel phases of 19-23, 25 (25k, 25m) and 26k, timed before
    anything else shares the card."""
    return {"19": phase_hybrid_kernels(torch, Q, DF, FA, KVQ, per_tensor_scale),
            "20": moe_kernels(torch, Q, DF, per_tensor_scale),
            "21": ssd_kernels(torch, Q, DF, per_tensor_scale),
            "22": phase_frontend_kernels(torch, Q, DF, FA, KVQ, per_tensor_scale,
                                         frontend_configs(get_config)),
            "23": phase_bf16_kernels(torch, FA, KVQ),
            "25": config_kernels(torch, Q, DF, FA, per_tensor_scale, get_config),
            "26": phase_family_kernels(torch, Q, DF, FA, TO, per_tensor_scale, get_config)}


def families_worker(torch, TM, Engine, ServeConfig, Request, Q, DF, FA, KVQ, TO, blocks,
                    per_tensor_scale, get_config, kernels, run_dir: Path) -> int:
    """The second process of a whole run: the kernels of 19-23, 25 and 26
    alone on the card (the first process waits), then 20, 22, 25's
    grok-1-314b and 26's heavy Trainers not in FAMILY_FIRST (holding the
    lock of the memory-heavy phases), 25's yi-9b, 21, 19, 23, 24, and 26's
    other Trainers not in FAMILY_FIRST and 26a of the configs not in
    FAMILY_CROSS_FIRST; hands their records over in
    ``run_dir/families.json``."""
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))  # the host is shared
    card = smi()
    t_run = time.perf_counter()

    def stamp(done: str) -> None:
        print(f"  [{done} done at {time.perf_counter() - t_run:.0f} s of the second process; "
              f"{torch.cuda.memory_reserved() / 2**30:.1f} GiB reserved]")

    kern = family_kernels(torch, Q, DF, FA, KVQ, TO, per_tensor_scale, get_config)
    torch.cuda.synchronize()
    (run_dir / "kernels.done").write_text("")
    stamp("phases 19-23, 25 and 26 (kernels)")
    ours = [a for a in FAMILY_TRAIN if a not in FAMILY_FIRST]
    with heavy_phase(run_dir):
        moe = moe_phases(torch, TM, Engine, ServeConfig, Request, Q, DF, FA, TO,
                         per_tensor_scale, get_config, card, b1=kern["20"])
        stamp("phase 20")
        fro = frontend_phases(torch, TM, Engine, ServeConfig, Q, DF, FA, KVQ, TO,
                              per_tensor_scale, get_config, card, rows=kern["22"])
        stamp("phase 22")
        cfg25 = config_serves(torch, TM, Engine, ServeConfig, Request, DF, FA, TO, get_config,
                              ("grok-1-314b",))
        stamp("phase 25 (grok-1-314b)")
        trains = family_trains(torch, TM, get_config, [a for a in ours if a in FAMILY_HEAVY])
        stamp("phase 26 (the heavy Trainers of this process)")
    cfg25.update(config_serves(torch, TM, Engine, ServeConfig, Request, DF, FA, TO, get_config,
                               [a for a in CONFIG_DENSE if a not in CONFIG_FIRST]))
    stamp("phase 25 (yi-9b)")
    ssd = ssd_phases(torch, TM, Engine, ServeConfig, Request, Q, DF, FA, TO, per_tensor_scale,
                     get_config, card, b1=kern["21"])
    stamp("phase 21")
    hyb = hybrid_phases(torch, TM, Engine, ServeConfig, Request, Q, DF, FA, KVQ, TO,
                        per_tensor_scale, get_config, rows=kern["19"])
    stamp("phase 19")
    # phase 5's float-KV bytes per token are the first process's: it holds
    # 23's bf16 figure to half of them
    bf = bf16_phases(torch, TM, Engine, ServeConfig, Request, FA, TO, KVQ, blocks, kernels,
                     get_config, kern=kern["23"])
    stamp("phase 23")
    train = train_phases(torch, Q, DF, FA, TO, TM, Engine, ServeConfig, get_config)
    stamp("phase 24")
    trains.update(family_trains(torch, TM, get_config, [a for a in ours
                                                        if a not in FAMILY_HEAVY]))
    stamp("phase 26 (" + ", ".join(a for a in ours if a not in FAMILY_HEAVY) + ")")
    cross_ours = [a for a in FAMILY_TRAIN if a not in FAMILY_CROSS_FIRST]
    cross = family_cross(torch, TM, get_config, cross_ours)
    stamp("phase 26a (" + ", ".join(cross_ours) + ")")
    bf = {**bf, "kernels": {f"{k}|{c}": v for (k, c), v in bf["kernels"].items()}}
    (run_dir / "families.json").write_text(json.dumps(
        {"hyb": hyb, "moe": moe, "ssd": ssd, "fro": fro, "bf": bf, "train": train,
         "cfg": {"kern": kern["25"], "serves": cfg25},
         "fam": {"kern": kern["26"], "trains": trains, "cross": cross}},
        default=_jsonable))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing is run on the CPU", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch import kvq as KVQ
    from repro_torch.core import quantized as Q
    from repro_torch.core.formats import per_tensor_scale
    from repro_torch.kernels import build
    from repro_torch.kernels import dsbp_fused as DF
    from repro_torch.kernels import dsbp_matmul as DM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fp8_quant_align as QA
    from repro_torch.kernels import ops as TO
    from repro_torch.models import blocks
    from repro_torch.models import model as TM
    from repro_torch import policy as P
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print("== phase 1: build")
    t0 = time.perf_counter()
    build.build_all()
    print(f"  built {build.LIBRARIES} in {time.perf_counter() - t0:.1f} s")
    for name, report in build.reports.items():
        print(f"  ptxas report, {name}.cu:\n" + "\n".join(
            "    " + line for line in report.strip().splitlines() if "ptxas" in line
            or "registers" in line or "spill" in line))

    if sys.argv[1:] == ["--kernels"]:  # phases 1-3, 6-8 and 11: the kernels alone
        phase_b1(torch, Q, DF, per_tensor_scale)
        phase_b2(torch, FA)
        phase_b3(torch, Q, QA, per_tensor_scale, build)
        phase_b4(torch, Q, DM, TO)
        phase_b5(torch, FA, KVQ)
        phase_b6_b7(torch, FA, KVQ)
        print(smi())
        return 0
    if sys.argv[1:] == ["--cross"]:  # phases 1, 4, 9 and 12: llama's CPU-vs-card checks
        cfg = get_config("llama-7b-paper")
        models = phase_cross_device(torch, TM, Engine, ServeConfig, cfg)
        phase_kv_cross_device(torch, Engine, ServeConfig, Request, blocks, KVQ, models, cfg)
        del models
        phase_paged_cross_device(torch, TM, Engine, ServeConfig, Request, FA, cfg)
        print(smi())
        return 0
    if sys.argv[1:] == ["--spec"]:  # phases 1, 4, 5, 13, 16a and 16: speculation
        cfg = get_config("llama-7b-paper")
        models = phase_cross_device(torch, TM, Engine, ServeConfig, cfg)
        model, _, _, _ = phase_serve(torch, TM, Engine, ServeConfig, Request, DF, FA, cfg)
        kernels = {"dsbp_fused": DF.dsbp_fused, "flash_attention": FA.flash_attention,
                   "packed_flash_attention": FA.packed_flash_attention,
                   "fp8_quant_align": QA.fp8_quant_align, "dsbp_matmul": DM.dsbp_matmul,
                   "paged_flash_attention": FA.paged_flash_attention,
                   "paged_packed_flash_attention": FA.paged_packed_flash_attention}
        paged = phase_paged_serve(torch, Engine, ServeConfig, Request, TO, KVQ, blocks,
                                  kernels, model, cfg)
        phase_spec_cross_device(torch, Engine, ServeConfig, Request, models, cfg)
        phase_spec_serve(torch, TM, Engine, ServeConfig, Request, TO, KVQ, DF,
                         per_tensor_scale, kernels, model, cfg, paged)
        print(smi())
        return 0
    if sys.argv[1:] == ["--robust"]:  # phases 1, 5, 13 and 18: robust serving
        cfg = get_config("llama-7b-paper")
        model, _, _, ref5 = phase_serve(torch, TM, Engine, ServeConfig, Request, DF, FA, cfg)
        kernels = {"dsbp_fused": DF.dsbp_fused, "flash_attention": FA.flash_attention,
                   "packed_flash_attention": FA.packed_flash_attention,
                   "fp8_quant_align": QA.fp8_quant_align, "dsbp_matmul": DM.dsbp_matmul,
                   "paged_flash_attention": FA.paged_flash_attention,
                   "paged_packed_flash_attention": FA.paged_packed_flash_attention}
        paged = phase_paged_serve(torch, Engine, ServeConfig, Request, TO, KVQ, blocks,
                                  kernels, model, cfg)
        phase_robust(torch, Engine, ServeConfig, Request, DF, FA, TO, kernels, model, cfg,
                     ref5, paged)
        print(smi())
        return 0
    if sys.argv[1:] == ["--policy"]:  # phases 1, 5, 17a and 17: the policy loop
        cfg = get_config("llama-7b-paper")
        model, _, _, ref5 = phase_serve(torch, TM, Engine, ServeConfig, Request, DF, FA, cfg)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        kernels = {"dsbp_fused": DF.dsbp_fused, "flash_attention": FA.flash_attention,
                   "packed_flash_attention": FA.packed_flash_attention}
        phase_policy_cross_device(torch, P, TM, Engine, ServeConfig, Request, Q.PRESETS,
                                  kernels, cfg)
        phase_policy(torch, P, TM, Engine, ServeConfig, Request, DF, FA, Q, per_tensor_scale,
                     KVQ, kernels, cfg, ref5, card)
        print(smi())
        return 0
    if sys.argv[1:] == ["--hybrid"]:  # phases 1 and 19: the Griffin hybrid
        hybrid_phases(torch, TM, Engine, ServeConfig, Request, Q, DF, FA, KVQ, TO,
                      per_tensor_scale, get_config)
        print(smi())
        return 0
    if sys.argv[1:] == ["--moe"]:  # phases 1 and 20: the MoE family
        moe_phases(torch, TM, Engine, ServeConfig, Request, Q, DF, FA, TO, per_tensor_scale,
                   get_config, card)
        print(smi())
        return 0
    if sys.argv[1:] == ["--ssd"]:  # phases 1 and 21: the SSD family
        ssd_phases(torch, TM, Engine, ServeConfig, Request, Q, DF, FA, TO, per_tensor_scale,
                   get_config, card)
        print(smi())
        return 0
    if sys.argv[1:] == ["--frontends"]:  # phases 1 and 22: the modality frontends
        frontend_phases(torch, TM, Engine, ServeConfig, Q, DF, FA, KVQ, TO,
                        per_tensor_scale, get_config, card)
        print(smi())
        return 0
    all_kernels = {"dsbp_fused": DF.dsbp_fused, "flash_attention": FA.flash_attention,
                   "packed_flash_attention": FA.packed_flash_attention,
                   "fp8_quant_align": QA.fp8_quant_align, "dsbp_matmul": DM.dsbp_matmul,
                   "paged_flash_attention": FA.paged_flash_attention,
                   "paged_packed_flash_attention": FA.paged_packed_flash_attention}
    if sys.argv[1:] == ["--bf16"]:  # phases 1 and 23: the bfloat16 dtype
        bf16_phases(torch, TM, Engine, ServeConfig, Request, FA, TO, KVQ, blocks, all_kernels,
                    get_config)
        print(smi())
        return 0
    if sys.argv[1:] == ["--train"]:  # phases 1 and 24: the training path
        train_phases(torch, Q, DF, FA, TO, TM, Engine, ServeConfig, get_config)
        print(smi())
        return 0
    if sys.argv[1:] == ["--train-families"]:  # phases 1, 26k, 26 and 26a: training families
        kern = phase_family_kernels(torch, Q, DF, FA, TO, per_tensor_scale, get_config)
        trains = family_trains(torch, TM, get_config, list(FAMILY_TRAIN))
        cross = family_cross(torch, TM, get_config, list(FAMILY_TRAIN))
        family_record(card, kern, cross, trains)
        print(smi())
        return 0
    if sys.argv[1:] == ["--configs"]:  # phases 1, 25k, 25m, 25a and 25: the copied configs
        kern = config_kernels(torch, Q, DF, FA, per_tensor_scale, get_config)
        cross = phase_config_cross_device(torch, TM, Engine, ServeConfig, get_config)
        serves = config_serves(torch, TM, Engine, ServeConfig, Request, DF, FA, TO, get_config,
                               (*CONFIG_DENSE, "grok-1-314b"))
        config_record(card, kern, cross, serves, get_config)
        print(smi())
        return 0
    if sys.argv[1:2] == ["--families-worker"]:  # the second process of a whole run
        return families_worker(torch, TM, Engine, ServeConfig, Request, Q, DF, FA, KVQ, TO,
                               blocks, per_tensor_scale, get_config, all_kernels,
                               Path(sys.argv[2]))
    if sys.argv[1:] == ["--mesh-only"]:  # phases 1, 5 and 14-15b, on every card there is
        model, launches, _, ref5 = phase_serve(torch, TM, Engine, ServeConfig, Request, DF,
                                               FA, get_config("llama-7b-paper"))
        ref5["launches"] = launches
        del model
        mesh_phases(torch, TM, Engine, ServeConfig, Request, DF, FA,
                    get_config("llama-7b-paper"), ref5)
        print(smi())
        return 0
    t_run = time.perf_counter()
    fam = None

    def stamp(done: str) -> None:  # the run's timeline against its time limit
        if fam is not None:
            fam.check()
        print(f"  [{done} done at {time.perf_counter() - t_run:.0f} s; "
              f"{torch.cuda.memory_reserved() / 2**30:.1f} GiB reserved]")

    # every kernel-timing phase alone on the card: this process's, then the
    # second process's (19-23) while this one waits
    b1_rows, b1_err = phase_b1(torch, Q, DF, per_tensor_scale)
    stamp("phase 2")
    b2 = phase_b2(torch, FA)
    stamp("phase 3")
    b3_rows, floor_ms = phase_b3(torch, Q, QA, per_tensor_scale, build)
    stamp("phase 6")
    b4_rows, b4_err = phase_b4(torch, Q, DM, TO)
    stamp("phase 7")
    b5 = phase_b5(torch, FA, KVQ)
    stamp("phase 8")
    b67 = phase_b6_b7(torch, FA, KVQ)
    stamp("phase 11")
    torch.cuda.synchronize()
    RUN_ROOT.mkdir(parents=True, exist_ok=True)
    run_dir = Path(tempfile.mkdtemp(dir=RUN_ROOT))
    fam = Families(run_dir)
    try:
        fam.wait_kernels()
        stamp("phases 19-23 and 25 (kernels), in the second process")
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))  # the host is shared
        cfg = get_config("llama-7b-paper")
        model, launches, float_bpt, ref5 = phase_serve(torch, TM, Engine, ServeConfig, Request,
                                                       DF, FA, cfg)
        stamp("phase 5")
        kernels = {"dsbp_fused": DF.dsbp_fused, "flash_attention": FA.flash_attention,
                   "packed_flash_attention": FA.packed_flash_attention,
                   "fp8_quant_align": QA.fp8_quant_align, "dsbp_matmul": DM.dsbp_matmul}
        kv_launches, _, trace10 = phase_kv_serve(torch, Engine, ServeConfig, Request, TO,
                                                 kernels, model, cfg, float_bpt)
        stamp("phase 10")
        phase_paged_cross_device(torch, TM, Engine, ServeConfig, Request, FA, cfg)
        stamp("phase 12")
        kernels.update(paged_flash_attention=FA.paged_flash_attention,
                       paged_packed_flash_attention=FA.paged_packed_flash_attention)
        paged = phase_paged_serve(torch, Engine, ServeConfig, Request, TO, KVQ, blocks, kernels,
                                  model, cfg)
        stamp("phase 13")
        spec = phase_spec_serve(torch, TM, Engine, ServeConfig, Request, TO, KVQ, DF,
                                per_tensor_scale, kernels, model, cfg, paged)
        stamp("phase 16")
        phase_robust(torch, Engine, ServeConfig, Request, DF, FA, TO, kernels, model, cfg, ref5,
                     paged)
        stamp("phase 18")
        spec_dense, spec_kv8 = spec["dense float, draft bits 4"], spec[
            "dense kv8, draft bits 4, kv_draft_bits 6"]

        # the policy loop, then the mesh (its ranks are processes of their
        # own, each drawing a whole model in turn): the models above are
        # freed first
        ref5["launches"] = launches
        del model
        gc.collect()
        torch.cuda.empty_cache()
        policy_kernels = {k: kernels[k] for k in ("dsbp_fused", "flash_attention",
                                                  "packed_flash_attention")}
        with heavy_phase(run_dir):
            phase_policy_cross_device(torch, P, TM, Engine, ServeConfig, Request, Q.PRESETS,
                                      policy_kernels, cfg)
            stamp("phase 17a")
            pol = phase_policy(torch, P, TM, Engine, ServeConfig, Request, DF, FA, Q,
                               per_tensor_scale, KVQ, policy_kernels, cfg, ref5, card)
            gc.collect()
            torch.cuda.empty_cache()
            stamp("phase 17")
            b8, mesh15 = mesh_phases(torch, TM, Engine, ServeConfig, Request, DF, FA, cfg, ref5)
            stamp("phase 14-15b")
            first25 = config_serves(torch, TM, Engine, ServeConfig, Request, DF, FA, TO,
                                    get_config, CONFIG_FIRST)
            stamp("phase 25 (phi3-medium-14b, deepseek-coder-33b)")
            trains26 = family_trains(torch, TM, get_config,
                                     [a for a in FAMILY_FIRST if a in FAMILY_HEAVY])
            stamp("phase 26 (the heavy Trainers of this process)")
        # llama-7b's one-layer CPU-vs-card checks, mostly the CPU's plain
        # versions, last: the second process's phase 24 binds the run
        models = phase_cross_device(torch, TM, Engine, ServeConfig, cfg)
        stamp("phase 4")
        phase_kv_cross_device(torch, Engine, ServeConfig, Request, blocks, KVQ, models, cfg)
        stamp("phase 9")
        spec16a = phase_spec_cross_device(torch, Engine, ServeConfig, Request, models, cfg)
        stamp("phase 16a")
        del models
        cross25 = phase_config_cross_device(torch, TM, Engine, ServeConfig, get_config)
        stamp("phase 25a")
        light = [a for a in FAMILY_FIRST if a not in FAMILY_HEAVY]
        if light:
            trains26.update(family_trains(torch, TM, get_config, light))
            stamp(f"phase 26 ({', '.join(light)})")
        cross26 = family_cross(torch, TM, get_config, FAMILY_CROSS_FIRST)
        stamp("phase 26a (" + ", ".join(FAMILY_CROSS_FIRST) + ")")
        mixed = pol["served"]["mixed + kv4"]
        rec = fam.finish()
        stamp("the second process")
    finally:
        fam.stop()
        shutil.rmtree(run_dir, ignore_errors=True)
    hyb, moe, ssd, fro, bf, train = (rec[k] for k in ("hyb", "moe", "ssd", "fro", "bf",
                                                      "train"))
    cfg25 = config_record(card, rec["cfg"]["kern"], cross25,
                          {**first25, **rec["cfg"]["serves"]}, get_config)
    # phase 23's bf16 llama holds half of phase 5's float-KV bytes per token
    half = bf["serve"]["float"]["kv_bytes_per_token"] / float_bpt
    print(f"  phase 23: bf16 float-KV bytes per token {half:.3f} of phase 5's")
    if half != 0.5:
        raise AssertionError(f"bf16 KV bytes per token are {half} of phase 5's")
    # each kernel's launches on the hybrid path (phase 19's counted run:
    # generate, serve, kv8, paged float and kv8 at full depth); B3, B4 and
    # B8 are not on it (dsbp_kernel and the mesh serve dense llama only)
    hyb_launches = hyb["recurrentgemma-2b"]["launches"]

    b1 = next(r for r in b1_rows if (r["M"], r["K"], r["N"]) == (4, 4096, 11008))
    b3 = next(r for r in b3_rows if (r["M"], r["K"]) == (4, 4096))
    b4 = next(r for r in b4_rows if (r["M"], r["K"], r["N"]) == (4, 4096, 11008))
    kernels = [
        {"name": "dsbp_fused", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dsbp_fused.cu",
         "replaces": "src/repro/kernels/dsbp_fused.py:73",
         "launches": launches["dsbp_fused"], "max_abs_err": b1_err,
         "ms": b1["ms"], "plain_ms": b1["plain_ms"], "bound_ms": b1["bound_ms"],
         "bound_by": b1["bound_by"], "library_ms": None,
         "spec_launches_by_step_and_m": {f"{k[0]} M={k[1]}": v
                                         for k, v in spec_dense["b1_m"].items()},
         "spec_path": f"phase 16 (dense float, {SPEC_LAYERS} layers, spec_k 3, draft bits 4, "
                      f"draft dsbp_fused)",
         "shape": "decode M=4 K=4096 N=11008", "path": "phase 5 (float KV, dsbp_fused)",
         "trace_ms_per_step": ref5["trace"]["B1_ms"] / ref5["trace"]["steps"],
         "policy_launches": mixed["launches"]["dsbp_fused"],
         "policy_launches_per_step": mixed["step_launches"]["dsbp_fused"],
         "policy_path": "phase 17 (mixed policy + kv4, generate + serve)",
         "rungs": pol["b1_rows"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:70",
         "launches": launches["flash_attention"],
         "max_abs_err": max(v["max_abs_err"] for v in b2.values()),
         "ms": b2["prefill"]["ms"], "plain_ms": b2["prefill"]["plain_ms"],
         "bound_ms": b2["prefill"]["bound_ms"], "bound_by": b2["prefill"]["bound_by"],
         "library_ms": b2["prefill"]["library_ms"],
         "decode_ms": b2["decode"]["ms"], "decode_library_ms": b2["decode"]["library_ms"],
         **{tag: {case: {k: b2[f"{case}-{model}"][k] for k in (
             "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")}
             for case in ("prefill", "decode")}
            for tag, model in (("gemma3_12b_d256", "gemma3-12b"), ("d320", "d320"),
                               ("d512", "d512"), ("mixtral_8x7b_gqa", "mixtral-8x7b"))},
         "spec_launches": spec_dense["launches"]["flash_attention"],
         "policy_launches": mixed["launches"]["flash_attention"],
         "policy_path": "phase 17 (mixed policy + kv4: prefill)",
         "shape": "prefill B=4 H=32 S=512 D=128", "path": "phase 5 (float KV, dsbp_fused)",
         "trace_ms_per_step": ref5["trace"]["B2_ms"] / ref5["trace"]["steps"]},
        {"name": "fp8_quant_align", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fp8_quant_align.cu",
         "replaces": "src/repro/kernels/fp8_quant_align.py:123",
         "launches": kv_launches["fp8_quant_align"], "max_abs_err": 0.0,
         "ms": b3["ms"], "plain_ms": b3["plain_ms"], "bound_ms": b3["bound_ms"],
         "bound_by": b3["bound_by"], "library_ms": None, "launch_floor_ms": floor_ms,
         "shape": "decode M=4 K=4096", "path": "phase 10 (kv8, dsbp_kernel)",
         "trace_ms_per_step": trace10["B3_ms"] / trace10["steps"]},
        {"name": "dsbp_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dsbp_matmul.cu",
         "replaces": "src/repro/kernels/dsbp_matmul.py:84",
         "launches": kv_launches["dsbp_matmul"], "max_abs_err": b4_err,
         "ms": b4["ms"], "plain_ms": b4["plain_ms"],
         "bound_ms": b4["bound_ms"], "bound_by": b4["bound_by"], "library_ms": None,
         "shape": "decode M=4 K=4096 N=11008 (either form)",
         "path": "phase 10 (kv8, dsbp_kernel)",
         "trace_ms_per_step": trace10["B4_ms"] / trace10["steps"]},
        {"name": "packed_flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:166",
         "launches": kv_launches["packed_flash_attention"],
         "max_abs_err": max(v["max_abs_err"] for v in b5.values()),
         "ms": b5["decode"]["ms"], "plain_ms": b5["decode"]["plain_ms"],
         "bound_ms": b5["decode"]["bound_ms"], "bound_by": b5["decode"]["bound_by"],
         "library_ms": None, "sdpa_dequantized_ms": b5["decode"]["sdpa_dequantized_ms"],
         **{tag: {k: b5[f"decode-{model}"][k] for k in (
             "ms", "plain_ms", "bound_ms", "sdpa_dequantized_ms", "max_abs_err")}
            for tag, model in (("gemma3_12b_d256", "gemma3-12b"), ("d320", "d320"),
                               ("d512", "d512"))},
         "spec_launches": spec_kv8["launches"]["packed_flash_attention"],
         "policy_launches": mixed["launches"]["packed_flash_attention"],
         "policy_launches_per_step": mixed["step_launches"]["packed_flash_attention"],
         "policy_path": "phase 17 (mixed policy, kv4 cache)", "kv4": pol["b5_kv4"],
         "shape": "decode B=4 H=32 S=2048 D=128, ragged", "path": "phase 10 (kv8, dsbp_kernel)",
         "trace_ms_per_step": trace10["B5_ms"] / trace10["steps"]},
    ]
    for name, kname, line, pool in (("paged_flash_attention", "B6", 264, "float"),
                                    ("paged_packed_flash_attention", "B7", 378, "kv8")):
        rows = {case: b67[(kname, case)]
                for case in ("serve", "decode", "decode-unshared", "chunk",
                             "decode-gemma3-12b", "decode-d320", "decode-d512")}
        main = rows["serve"]
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": f"src/repro/kernels/flash_attention.py:{line}",
             "launches": paged[pool]["launches"][name],
             "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
             "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
             "bound_by": main["bound_by"], "library_ms": None,
             "dense_over_gathered_ms": main["dense_ms"],
             "gather_sdpa_ms": main["gather_sdpa_ms"],
             "others": {case: {k: r[k] for k in ("ms", "dense_ms", "plain_ms", "bound_ms",
                                                 "gather_sdpa_ms", "keys")}
                        for case, r in rows.items() if case != "serve"},
             "spec_launches": spec[f"paged {pool}"]["launches"][name],
             "shape": "decode, 8 lanes H=32 D=128 bs=16 MB=32 (phase 13's)",
             "path": f"phase 13 (paged, {pool} pool, dsbp_fused)"})
    b8m = next(r for r in b8 if (r["proj"], r["M"]) == ("w2", 4))
    kernels.append(
        {"name": "dsbp_fused_sharded_call", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dsbp_fused.cu",
         "replaces": "src/repro/kernels/dsbp_fused.py:135",
         "launches": mesh15["ranks"][0]["launches"]["dsbp_fused_sharded_call"],
         "max_abs_err": max(r["max_abs_err"] for r in b8),
         "ms": b8m["ms"], "plain_ms": b8m["plain_ms"], "bound_ms": b8m["bound_ms"],
         "bound_by": b8m["bound_by"], "library_ms": None,
         "b1_shard_ms": b8m["b1_shard_ms"], "collective_ms": b8m["collective_ms"],
         "host_collective_ms": b8m["host_collective_ms"],
         "others": {f"{r['proj']} M={r['M']}": {k: r[k] for k in (
             "ms", "b1_shard_ms", "collective_ms", "host_collective_ms", "plain_ms",
             "bound_ms", "n_diff", "ulps")}
             for r in b8 if r is not b8m},
         "shape": "decode M=4, w2 row-parallel K=11008 N=4096 over 2 ranks (rank 0's "
                  "whole call, collectives included)",
         "path": "phase 15 (mesh (1, 2), two ranks on the one card, per rank)"})
    hyb_rows = hyb["kernels"]["attn"]
    for k in kernels:
        k["hybrid_launches"] = hyb_launches.get(k["name"], 0)
        k["hybrid_path"] = "phase 19 (recurrentgemma-2b, 26 layers, full width)"
    by_name = {k["name"]: k for k in kernels}
    by_name["dsbp_fused"]["hybrid_rows"] = hyb["kernels"]["b1"]
    for name, rows in (("flash_attention", ("B2 prefill", "B2 decode")),
                       ("packed_flash_attention", ("B5 decode",)),
                       ("paged_flash_attention", ("B6 decode",)),
                       ("paged_packed_flash_attention", ("B7 decode",))):
        by_name[name]["hybrid_rows"] = {r: hyb_rows[r] for r in rows}
    # each kernel's launches on the MoE path: B1 and B2 over phase 20's
    # counted run (32 layers: generate + serve), B5 / B6 / B7 over 20b's
    # (4 layers: kv8, paged float and kv8)
    for k in kernels:
        part = "20" if k["name"] in ("dsbp_fused", "flash_attention") else "20b"
        k["moe_launches"] = moe[part]["launches"].get(k["name"], 0)
        k["moe_path"] = (f"phase {part} (mixtral-8x7b, full width, "
                         + ("32 layers: generate + serve)" if part == "20" else
                            f"{moe['20b']['depth']} layers: kv8, paged float and kv8)"))
    by_name["dsbp_fused"]["moe_rows"] = moe["b1"]
    # each kernel's launches on the SSD path (phase 21's counted run, 48
    # layers: generate, serve, kv8, paged): B1 alone, the model attends
    # nowhere
    for k in kernels:
        k["ssd_launches"] = ssd["21"]["launches"].get(k["name"], 0)
        k["ssd_path"] = "phase 21 (mamba2-370m, 48 layers, full width)"
    by_name["dsbp_fused"]["ssd_rows"] = ssd["b1"]
    # each kernel's launches on the frontend path (phase 22's counted runs
    # at full depth: musicgen-large's and llava-next-34b's generate, float
    # KV then kv8): B1, B2 and B5
    for k in kernels:
        k["frontend_launches"] = sum(fro[arch]["launches"].get(k["name"], 0)
                                     for arch in ("musicgen-large", "llava-next-34b"))
        k["frontend_path"] = ("phase 22 (musicgen-large 48 layers, llava-next-34b 60 layers, "
                              "full width: generate, float KV and kv8)")
    by_name["dsbp_fused"]["frontend_rows"] = fro["kernels"]["b1"]
    by_name["flash_attention"]["frontend_rows"] = fro["kernels"]["b2"]
    by_name["packed_flash_attention"]["frontend_rows"] = fro["kernels"]["b5"]
    # the bf16 instantiations (phase 23): one entry each, launches over
    # phase 23's counted runs (B2 / B5: generate + serve at full depth;
    # B6 / B7: the paged serves)
    bfs, bfk = bf["serve"], bf["kernels"]
    for name, kname, line, case, launches in (
            ("flash_attention", "B2", 70, "prefill",
             bfs["float"]["bf16_launches"]["flash_attention"]),
            ("packed_flash_attention", "B5", 166, "decode",
             bfs["kv8"]["bf16_launches"]["packed_flash_attention"]),
            ("paged_flash_attention", "B6", 264, "serve",
             bfs["paged"]["float"]["launches"]["paged_flash_attention"]),
            ("paged_packed_flash_attention", "B7", 378, "serve",
             bfs["paged"]["kv8"]["launches"]["paged_packed_flash_attention"])):
        row = bfk[(kname, case)]
        kernels.append(
            {"name": f"{name} (bf16)", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": f"src/repro/kernels/flash_attention.py:{line}",
             "launches": launches,
             "max_abs_err": max(v["max_abs_err"] for (k, _), v in bfk.items() if k == kname),
             "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": row["library_ms"],
             "library": row["library"], "f32_ms": row["f32_ms"],
             "others": {c: {k: v[k] for k in ("ms", "f32_ms", "plain_ms", "bound_ms",
                                                "library_ms", "max_abs_err")}
                        for (k, c), v in bfk.items() if k == kname and c != case},
             "shape": f"{kname} {case} (phase 23's)", "path": "phase 23 (llama-7b-paper bf16)"})
    # each kernel's launches per step on the training path (phase 24: the
    # dsbp_fused QAT step; B3 and B4 run the dsbp_kernel product of 24k)
    for k in kernels:
        k["train_launches_per_step"] = train["24"]["launches_per_step"].get(k["name"], 0)
        k["train_path"] = (f"phase 24 (llama-7b-paper, {TRAIN_LAYERS} layers, full width, "
                           f"dsbp_fused QAT with remat)")
    # each kernel's launches on phase 25's path (generate + serve of each
    # config: yi-9b, phi3-medium-14b and deepseek-coder-33b at full depth,
    # grok-1-314b at GROK_LAYERS): B1 and B2
    for k in kernels:
        k["configs_launches"] = sum(cfg25[a]["launches"].get(k["name"], 0)
                                    for a in (*CONFIG_DENSE, "grok-1-314b"))
        k["configs_path"] = (f"phase 25 (yi-9b 48, phi3-medium-14b 40, deepseek-coder-33b 62, "
                             f"grok-1-314b {GROK_LAYERS} layers, full width: generate + serve)")
    by_name["dsbp_fused"]["configs_rows"] = cfg25["kernels"]["b1"]
    by_name["flash_attention"]["configs_rows"] = cfg25["kernels"]["b2"]
    # each kernel's launches per step on phase 26's Trainers (full width,
    # the depths of FAMILY_TRAIN, dsbp_fused QAT with remat): B1 and B2
    fam26 = family_record(card, rec["fam"]["kern"], {**cross26, **rec["fam"]["cross"]},
                          {**trains26, **rec["fam"]["trains"]})
    for k in kernels:
        k["train_families_launches_per_step"] = {
            a: r["launches_per_step"].get(k["name"], 0) for a, r in fam26["26"].items()}
        k["train_families_path"] = ("phase 26 (" + ", ".join(
            f"{a} {FAMILY_TRAIN[a][0]} layers" for a in FAMILY_TRAIN)
            + ", full width: a Trainer's step, dsbp_fused QAT with remat)")
    by_name["dsbp_fused"]["train_families_rows"] = fam26["26k"]["b1"]
    by_name["flash_attention"]["train_families_rows"] = fam26["26k"]["b2"]
    print("speculation (phase 16): " + json.dumps(spec_record(spec, spec16a)))
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
