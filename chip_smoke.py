#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

It drives the serving paths of the dense GQA family (Yi-6B, slice 1: K1
and K2), GLM-5's MLA + MoE path (slice 2: K3 and K4; with DSA on, its MLA
layers write the indexer keys and read none), DSA sparse attention on GQA
(Yi-6B with its own DSAConfig, slice 3: K5 and K6), the DSA block
selector (slice 5: Yi-6B + DSA(block), K5 for a decode step, K7 + K8 for
a span), GLM-5's MTP speculative decode (slice 5: spans through K4) and
the attention-free Mamba-1 family (slice 6: falcon-mamba-7b through the
static ServingEngine, K11 selective scan in prefill and decode), the
hybrid family (slice 13: zamba2-2.7b's Mamba-2 layers on K11's
head-shared form and its one shared attention block on K1/K2 at head dim
80, or K5/K6 with DSA, through the ContinuousEngine); and the
training path (slice 4: the Muon Split trainer on Yi-6B, Yi-6B + DSA and,
slice 5, Yi-6B + DSA(block) at full width, 8 layers; slice 6,
falcon-mamba-7b at full width, 8 layers; slice 17, zamba2-2.7b and
zamba2 + DSA at full width, 12 layers; K9 flash attention, K10 chunked
cross-entropy, K7 lightning indexer, K8 block-sparse attention, K11);
and the rest of the model registry (slice 19): phi-3-vision (family vlm:
patch embeddings before the text; K1/K2/K9 at head dim 96), whisper-base
(family audio, the encoder-decoder: K9 not causal, Sq != Sk) and the
qwen3-moe, kimi-k2, nemotron-4 and minitron configs (K1/K2 at G 16, 8,
6 and 3), each without the repo's DSA retrofit, as published.
Phases, each printing lines of numbers (any failure exits non-zero):

  build    compile the hand-written CUDA kernels from ``src/repro_torch/csrc``
           with nvcc for sm_90a into ``build/`` (cached by source hash), one
           nvcc per source, all started together;
  kernels  K1 (split-KV paged decode) and K2 (span prefill) against their
           plain PyTorch versions at Yi-6B shapes (KVH 4, G 8, d 128) and a
           gemma2-like shape (KVH 4, G 2, d 256, window 64, softcap 50),
           block sizes 16 and 8, fp32 (atol 1e-4) and bf16 (atol 2e-2, one
           bf16 ulp at unit scale plus summation order), on ragged rows:
           a trash row of length 0, length 1, block boundaries, a span
           starting mid-block, shuffled tables; then K3 (absorbed-MLA
           decode; bf16: its tensor-core tile, split-KV, held at the parts
           its wrapper picks, at parts 1 and at 16, where parts past a
           short row's rounds hold no key; fp32: its SIMT body) and K4 (MLA
           span prefill) the same way at GLM-5 shapes (H 64, kv_lora 512,
           rope 64) and at H 16, block sizes 8, 16 and 32, with fp32 q_lat
           and the pools and q_rope in fp32 or bf16, and K4 (bf16: its
           tensor-core tile; fp32: its SIMT body) over block sizes 8, 16
           and 32 with a trash row, spans from position 1, across a block
           edge, at one, mid-block and ending at the table's last
           position, S 37 and verify spans of S 4 (the bf16 wrapper splits
           their key range into 4 parts); then K5 (indexer decode
           scores) and K6 (span scores) at Yi-6B's (Hi 16, Di 64),
           GLM-5's (Hi 32, Di 128) and zamba2's (Hi 8, Di 64) indexer
           shapes (bf16: their tensor-core bodies, K5's SIMT tile at 8
           heads; fp32: the SIMT tile), block sizes 8, 16 and 32, spans
           with an idle slot, where the dead blocks (NEG_INF) must also
           match; then K9 (fp32: its 3xTF32 tensor-core tile; bf16: the
           bf16 tensor-core tile, also at forced parts 1 and 4; d
           64/128/256 each with causal, window, softcap, q_offset and
           non-causal cases, d 80 at zamba2's 32 / 32 heads causal and
           not and with q_offset; S*G and Sk ragged), K7 (Hi x Di 16x64,
           32x128, 8x64 (the tensor-core body at one n-tile), 2x16; S and
           T ragged) and K10 (Tk and V ragged,
           softcap 0 and 30, a partial mask; its two sums held to 1e-5
           relative), and the gradients through their autograd
           Functions on the kernel and the plain routes (equal); then K8
           at Yi-6B's shape (H 32 / KVH 4, d 128, 16 blocks of 128),
           GLM-5's MLA shape (H 64, dqk 192, dv 256) and the smoke shape
           (4 blocks of 16), queries from mid-sequence, skipped ids,
           softcap 0 and 50, fp32 (its 3xTF32 tile) and bf16 (its bf16
           tile), and its gradients on both routes; then K11 (both entry
           points: the model form, which discretizes inside and cuts time
           into the chunks its wrapper picks, and the Pallas contract) at
           falcon-mamba's
           width (E 8192, N 16), the smoke width (E 512, N 8) and a ragged
           E (96), S 1 / 7 / 256 / 1024, fp32 and bf16 inputs, fp32 and
           bf16 nonzero states (the model form's fp32 outputs held at the
           fp32 tolerance whatever the inputs' dtype; the contract form's
           outputs, stored in its input dtype, may also differ by one ulp
           of their magnitude), and the gradients through its autograd
           Function on both routes; K11's head-shared (Mamba-2) form at
           zamba2's width (80 heads of 64, N 64), at P 64 with N 16 / 32
           and a ragged one (3 x 40), S 1 / 77 / 130 / 200 / 1024, both
           dtypes and both state dtypes, through the wrapper (the chunked
           route on the tensor cores at P 64, S > 1), the chunked route
           forced at 1 and 3 heads a CTA and the thread-a-channel body at
           parts 1 and 16 (y at the fp32 tolerance, hT stored in the
           state's dtype), and its training route ``mamba2_scan`` (the
           kernel forward, the chunked plain backward) at S 200, A down
           to -80, every input's gradient within 1e-4 of its max against
           autograd through the stepped plain scan; K1 and K2 also at
           zamba2's shared-block shape (32 heads of 80, G 1) in the first
           list; slice 19 adds to it K1/K2 at phi-3-vision's 32 heads of 96
           (G 1) and at d 128 with minitron's G 3, nemotron-4's G 6 and
           qwen3-moe's G 16, K5/K6/K7 at minitron's 12 x 64 indexer (the
           SIMT tile), K9 at d 96 (causal, not, q_offset + softcap) and at
           whisper's shapes (8 x 64, not causal: 448 and 1 queries against
           1500 frames, the 1500 frames against themselves), its
           gradients through ``flash_attend`` at d 96 (causal and not) and
           at whisper's cross shape, and K10 at V 32064 / D 3072, V 51865
           / D 512 and V 163840 / D 7168, both dtypes;
  timing   K3/K4's and K5/K6's registers, spills, shared memory and CTAs
           resident on an SM, as the CUDA runtime reports them (K3's parts
           and CTAs at the decode step; the indexer tensor-core bodies at
           both indexer shapes: K5's decode form, K6's bf16 (also at
           zamba2's 8 x 64), K7's bf16 and fp32), and those
           of the tensor-core tiles: the bf16 one K2, K8 and K9 share
           (csrc/mma_tile.cuh; K9 at every head dim with the parts its
           wrapper picks at the RL loop shape) and K4's bf16 MLA tile
           (csrc/paged_mla.cu),
           with the key-range split the wrapper picks at the serve shapes
           (K4: its chunk and its verify span), and the fp32 3xTF32 tile
           (csrc/tf32_tile.cuh) of K9 at every head dim and of K8 at the
           training chunk and GLM-5's MLA shape, K1's split-KV decode
           body in both dtypes with the parts the wrapper picks for the
           decode step, and K10's logits tiles (fp32 3xTF32, bf16 SIMT);
           and the HMMA instructions of each of the tiles' instantiations
           in the built libraries, K1's bf16 body, K3/K4's tile and K5's
           and K6's among them
           (cuobjdump -sass; K8's, K9's and K10's fp32 tiles' must all be
           HMMA .TF32, the bf16 ones' none; fails where one has none);
           then
           each kernel, its plain version and one PyTorch library call
           (scaled_dot_product_attention over the KV gathered and its heads
           repeated once, before the timed loop; timed here only, the port
           never calls it) at the serve phase's shapes, with the least time
           the card could take (bytes over 3.35 TB/s or flops over 989
           TFLOP/s, whichever is larger); at these shapes each kernel is
           also held against its plain version, in bf16 and in fp32, with
           the tolerances above scaled by min(1, max|plain|); K1 at the
           parts its wrapper picks and at parts 1, its line carrying the
           device time (CUDA graph) beside SDPA's (library_device_ms), the
           wrapper's host microseconds a call (back-to-back calls, no
           synchronise), the parts, GB/s and the bound's share; K3 and K4
           at GLM-5's serve shapes, K3's line with the same numbers as K1's
           but SDPA's device time, held at its parts and at parts 1, K4 at
           a prefill chunk and at the
           verify span of a spec-3 round over the decode batch (B 8, S 4;
           the library call there is SDPA over
           q = [q_lat | q_rope], k = [c | kr] and v = c, the latent
           gathered and expanded to the 64 heads before the timed loop);
           K5 at a decode step and K6 at a 256-token span ending at 6143
           of the DSA serve phase, on a 32-layer k_idx pool (no single
           library call computes their ReLU between product and head sum,
           so no library time), with the top-2048 sets chosen from the
           kernel's and from the plain scores compared (they may differ
           only at near-ties of the 2048th score; their count is printed),
           K5's and K6's lines (their bf16 tensor-core bodies) also with
           their CUDA-graph device time and their wrappers' host
           microseconds a call;
           K9, K10 and K7 at the training runs' shapes in fp32 (Yi-6B's,
           and zamba2's on lines tagged ``_zamba2``: K9 at 32 heads of 80,
           K10 at D 2560 / V 32000, K7 at 8 x 64; TF32 is
           off; all three run 3xTF32 on the tensor cores, so each is bound
           by its three TF32 products over 494.7 TFLOP/s, the CUDA cores'
           67 TFLOP/s bound logged beside; each with a CUDA-graph device
           time; K7's line with the count of top-2048 indices the selector
           would pick differently from its scores and the plain ones, all
           near-ties), K9
           beside scaled_dot_product_attention(
           is_causal=True), whose kernel the profiler names; K10 there on
           unit-scale logits, as the model's, so that the part of its sum
           that depends on h.W is far above the 1e-5 relative tolerance;
           K8 at a 256-token span ending at 6144 of the block-selector
           serve (bf16, and fp32 on its own line) and at the block training
           run's last 256-query chunk against 4096 keys (fp32; both fp32
           lines bound by three TF32 products, as K9's), beside SDPA
           over each query block's selected K/V gathered before the timed
           loop, with the key-range parts its wrapper picks; K7 (bf16, its
           tensor-core body) at the block selector's last serve span of the
           6144-token prompt (S 256 against the 6528-position view; the
           shape logged), with its device time, host microseconds a call
           and the fp32 route's error there; K2's and
           K4's fp32 bodies at their serve shapes on lines
           of their own; K2's, K4's, K8's and K9's lines carry, beside the
           wrapper's CUDA-event time, the
           device time of the same calls replayed from a CUDA graph (the
           wrapper's host overhead taken out) and the TFLOP/s that gives;
           K1/K2 at zamba2's shared block (head dim 80, G 1, its 9
           invocations' pools) and K5/K6 at its 8 x 64 indexer (both on
           their tensor-core bodies at one n-tile of heads), lines tagged
           ``_zamba2``; K11's head-shared form's kernels' registers,
           spills, shared memory and CTAs an SM (N 64), at a zamba2
           prefill span (B 1, S 256: the chunked route, its three
           kernels' device times, and the parent's thread-a-channel body
           in turns with it) and decode step (B 8: the one-step kernel,
           device time and host microseconds a call);
           K9's bf16 route (the bf16 tensor-core tile, the parts its
           wrapper picks) at the RL loop backend's re-forward (B 1, S
           240, Yi-6B's heads), its own line ``flash_attention_bf16``,
           with SDPA's device time from the same graph replay;
           K11's scan kernel's registers, spills, shared memory and CTAs
           an SM, its model
           form at falcon-mamba's serve prefill (B 8, S 1024, bf16), decode
           step (B 8, S 1; with its CUDA-graph device time and the
           wrapper's host microseconds a call) and training shape (B 2,
           S 2048, fp32), each with the time chunks its wrapper picks, its
           contract form at B 1, S 256 (no single library call computes
           the recurrence; the expf's special-function-unit bound is
           logged beside the bytes / operations bound); K10 again at the
           falcon-mamba trainer's shape (2 x 2048 tokens, D 4096, V 65024),
           held as at Yi-6B's; K11's head-shared form at zamba2's
           training shape (B 2, S 2048, fp32: ``mamba_scan_heads
           (train)``; the chunked route beside the parent's body in the
           same call), its plain stepped version and its chunked plain
           backward's time and memory beside the forward's; K1/K2 at
           phi-3-vision's and qwen3-moe's shapes over 8 layers' pools
           (lines tagged ``_phi3``, ``_qwen3``), K9 and K10 at phi-3's
           training shape (B 1, 576 patches + 1472 tokens) and at
           whisper's (K9 over the encoder's 1500 frames, B 8, not
           causal; K10 over 8 x 448 tokens), tagged ``_phi3`` and
           ``_whisper``;
  parity   Yi-6B at full width with 2 layers in fp32: the port's
           ContinuousEngine (mid-flight admission, a shared prefix with a
           radix hit and a COW fork, chunked prefill) gives the same greedy
           tokens as the ServingEngine oracle, wherever the top-2 logit
           margin is at least 1e-3 (prompts without one are skipped; the
           oracle and the margins run on the plain route, so their DSA
           scores do not come from K7, whose tile body K5/K6 share); then
           the same for Yi-6B with DSA, with prompts of 2600 and 3000
           tokens (top-2048 discards keys) beside short ones; then GLM-5
           (DSA on) at full width with 2 layers (1 dense-MLP MLA layer + 1
           MLA + MoE layer with all 256 experts) in fp32, ~49 GB; then
           Yi-6B + DSA(block) at 2 layers on the long mix with spans of
           256, the kernel route against the same engine on the plain
           route (the static oracle prefills other spans, and the block
           selector depends on them), K8 launched on the first only; then
           GLM-5 + DSA + MTP at 2 layers: spec_steps=3 against
           spec_steps=0, and a run with the drafts pointed at the spec-off
           tokens (every draft accepts), tokens equal, their true
           logprobs (bonus tokens and accepted drafts from the verify
           span) within 1e-4 relative of spec off's; then falcon-mamba-7b
           at full width with 2 layers in fp32 through the static
           ServingEngine (its family's engine; the ContinuousEngine refuses
           it, as the reference's does), batches of 3 left-padded prompts:
           the kernel route's greedy tokens equal to the plain route's
           wherever the padded row's top-2 margin is >= 1e-3, K11's
           launches one a layer a prefill and a decode step; and prefill +
           decode logits equal to the full forward's; then zamba2-2.7b at
           full width with 12 layers (two shared-block invocations, so the
           second reads the pool at table + stride) in fp32, dsa=None on
           the short mix and with DSA on the long one, each with
           whole-prompt and 64-token chunked prefill: the ContinuousEngine
           (prefix cache off, slots reused) against the static oracle on
           the plain route (K11's plain head-shared scan), as above; then
           the serving layers around the engine (``[frontend.parity]``):
           Yi-6B at full width with 2 layers in fp32 through
           ``AsyncFrontend`` on a 40-block pool with the host spill tier
           off and on (the 200-token system prompt is demoted between
           waves and then restored) and through ``DisaggServer``
           (``pd_threshold`` 200: the long prompts prefill on their tier
           and migrate), each against the oracle as above, spill on equal
           to off; then the rest of the registry in fp32: phi-3-vision at
           full width, 2 layers, its ``make_prefill_step`` over 576 patch
           embeddings (logits within 1e-4 of max(1, |plain|) of the plain
           route's, K9 once a layer) and its engine on text-only requests
           against the oracle as above; whisper-base whole, 4 rows of 1500
           frames and 32 prompt tokens: prefill + 16 greedy decode steps
           equal to the full forward over the tokens chosen, and the
           tokens equal to the plain route's where the margin holds;
           qwen3-moe, nemotron-4 and kimi-k2 (at 2 dense layers,
           first_k_dense=2) at full width, 2 layers, against the oracle;
  serve    Yi-6B at full width and depth (32 layers, dsa=None) in bf16 on a
           2 GiB pool: 8 requests of 32..1024 prompt tokens, half sharing a
           system prefix, prefill_chunk 256; then (``[frontend]``) the same
           mix on the same model through ``AsyncFrontend`` (TTFT / TPOT p50
           beside the engine-direct run's), again with a weight push
           mid-run (version stamps), with ``crash@12`` (one restart, zero
           lost, every failure typed), with the host spill tier on a pool
           of two of the longest requests (demotions, restores, restore
           GB/s) and through ``DisaggServer`` (``pd_threshold`` 256;
           migrations, migrated blocks, migrate ms), healthy and with two
           ``xfer`` faults (fallbacks equal to them); any restart or
           fallback not injected fails the run; then asynchronous agent
           RL (slice 15): ``[rl.parity]``, Yi-6B width at 2 layers in
           fp32, one fp32 ``RolloutEngine`` serving one orchestrator
           worker through the front-end, two GRPO groups of 8 at
           temperature 1 on prompts of exactly 64 tokens, then one
           ``AsyncTrainer.train_on`` before any push: the captured
           behaviour logprobs and the trainer's recomputed ones within
           1e-3 a token, the mean ratio within 1e-3 of 1, every token
           kept; ``[rl]``, Yi-6B width at 4 layers: the fp32 trainer
           (Muon Split, lr 1e-3, a push every 2 steps) for 4 steps of 2
           groups against two bf16 rollout engines (two workers, groups
           of 8, tau 4, the copy and reverse tasks on a 216-token system
           prompt), then one group through the loop backend (a bf16
           re-forward a token, K9's bf16 route): step and push ms,
           rollout tokens/s and groups/s, the staleness histogram, kept
           and ratio a step, prefix-cache hits, peak memory and the
           launches of K1, K2, K9 fp32 (one a layer a step) and K9 bf16
           (one a layer a loop token), checked; the first step's ratio
           within [0.9, 1.1]; then Yi-6B with DSA (16
           layers; K5 and K6 in every layer) on 8 requests of 32..6144
           prompt tokens (four past top-k) with a 2.1 GiB pool; then
           Yi-6B + DSA(block) on the same mix (the view a whole number of
           128-blocks; K8's launches checked against the spans that reach
           it); then GLM-5 at full width with 4 layers (3 dense-MLP MLA
           layers + 1 MLA + MoE layer, DSA on) and its MTP layer (~27 GB
           of bf16 weights) on the first request mix, spec_steps=0 and
           then spec_steps=3 (accept length, rounds, TPOT / TTFT / decode
           tok/s beside spec off), and with ``true_logprobs`` at spec 0
           and 3 (tokens equal, first partings and logprob gaps printed:
           the MoE router's near-ties part the runs in bf16), then the
           same widths with every layer dense: the verify span's
           logprobs (K4) within 2e-2 relative of the decode steps' (K3)
           up to and including the first token the runs choose
           differently; then zamba2-2.7b at full width, depth 54 -> 24
           (4 shared-block invocations) in bf16, dsa=None on the first
           mix and with DSA on the DSA mix (K11's head-shared launches
           checked: one a layer a decode step and a prefill span); then
           falcon-mamba-7b at full width and
           depth (64 layers, 7.27 B parameters, bf16) through the static
           ServingEngine on the first mix's 8 prompts in one left-padded
           batch, 32 new tokens: prefill ms (the batch's TTFT), decode step
           ms p50 and decode tok/s, timed by the script around the engine's
           calls (it stamps no times), K11's launches (64 + 32 x 64 = 2112)
           and K10's (0); then phi-3-vision at full width and depth (32
           layers, bf16) on the first mix (text-only requests) and one
           ``make_prefill_step`` over 576 patches + 1472 tokens; qwen3-moe,
           kimi-k2 (1 dense + 1 MoE layer of 384 experts, ~40 GB),
           nemotron-4 and minitron at full width, depth 2, on the first
           mix; whisper-base whole through ``launch.steps`` (8 rows of
           1500 frames, 16 prompt tokens, 64 greedy tokens: encode ms,
           prefill ms, decode step ms p50, decode tok/s, K9's launches;
           ``make_prefill_step``'s logits against the prefill's at the
           bf16 bound).  Each path's kernels' launch counters
           are set to 0 just before and read just after its run;
  train    one Muon step on the kernel route and one on the plain route
           (the three wrappers pointed at their plain versions) from the
           same fp32 weights and batch, Yi-6B width at 2 layers, dense (seq
           1024), with DSA and with DSA(block) (seq 2560), and
           falcon-mamba-7b's width at 2 layers (seq 1024; K11 on one route,
           its plain version on the other): loss, every
           gradient and every parameter after the step within the
           tolerances of ``train_parity``; then the trainer
           (``launch.train.train``) for 5 steps of Yi-6B (4 layers, dense,
           batch 2 x 2048), of Yi-6B + DSA and of Yi-6B + DSA(block) (4
           layers, batch 1 x 4096) and of falcon-mamba-7b (4 layers,
           batch 2 x 2048): losses finite and falling, step ms,
           tokens/s, peak memory, and the launches of K7/K8/K9/K10/K11,
           which must equal the count expected from the depth and the
           chunks; then zamba2-2.7b and zamba2 + DSA at full width, depth
           54 -> 12 (two shared-block invocations, whose gradients sum):
           train parity (seq 1024 dense, 2560 with DSA, past top-k; the
           DSA indexer's leaves get no gradient on either route, as the
           reference drops its loss) and 5 trainer steps (2 x 2048 dense,
           1 x 4096 with DSA at 6 layers, one invocation; K9 at d 80 or K7
           at 8 x 64, K10, K11's
           head-shared form a Mamba-2 layer); then phi-3-vision at full
           width (train parity at 2 layers, 576 patches + 1472 tokens; 5
           steps at 8 layers, B 1) and whisper-base whole (train parity at
           B 2, 5 steps at B 8 x 448 text tokens over 1500 frames),
           batches with their embeddings (``train_run_frontend``: the
           trainer's loop, which its token corpus cannot feed);
  profile  one training step of each training run (at 2 layers since
           slice 19; zamba2 at 6, one group, its scan gradients timed
           apart) cut into
           its layers (forward, loss, backward, Muon; synchronised) and
           one traced with torch.profiler (busy share, top kernels, K7/K8/
           K9/K10/K11 device time, found by kernel name: a kernel the step
           launched that no name matches fails the run; the block-selector
           and falcon-mamba runs too); 8 static-engine decode steps of the
           full-depth falcon-mamba at 8 rows after 512-token prompts,
           traced (busy share, K11 device time a call); then 8
           decode-only steps of each served model
           at 8 rows, timed and
           then traced with torch.profiler: device busy share, top kernels
           and the port's own kernels' device time a call (Yi-6B with DSA
           at ~2300 live tokens a row, past top-k; zamba2 as published).
  mesh     the mesh and analysis layer (slice 20) on the host mesh
           (``launch.mesh.make_host_mesh``: 1 x 1, a process group of one
           rank over NCCL, started before the serve and train phases,
           which reuse it): for the served qwen3-moe and kimi-k2 (depth
           2, bf16), ``launch.steps``' prefill step (256 tokens) and one
           serve step (8 rows after 64 tokens) with
           ``moe_impl="expert_parallel"`` against the routed path at a
           capacity factor that drops nothing (16 / 48: E / k), at bf16
           2e-2 of the logits' scale; two EP runs bitwise equal; the EP
           serve step under ``torch.cuda.set_sync_debug_mode("error")``;
           the dropped assignments a layer and step at the default 1.25
           and the serve step's ms p50, EP beside routed (``[mesh]
           model=... capacity_factor=1.25``); ``cfg.remat`` on Yi-6B at 8
           layers, 2 x 2048, fp32: ``remat="full"`` at ``remat_group`` 1
           and 2 against ``"none"`` (loss 1e-5 relative, gradients 1e-4
           of each leaf's max), each one's peak memory, forward +
           backward ms and ``model_flops`` over it as a share of the fp32
           peak (``[mesh] ... what=remat``, ``what=remat.summary``); and
           ``launch.dryrun``'s argument bytes for Yi-6B at 2 layers,
           ``decode_32k`` at batch 8, beside what the card allocates for
           the same parameters, token and cache (``[mesh] ...
           what=dryrun``).  Every [mesh] line carries the card's name and
           power limit.

Slice 21 (the rest of DSA, and gemma2-2b) adds, in those phases: K5 and
K6's top-k sets compared with the randomized top-k's noise added to both
routes (``[dsa.random] kernel=...``); gemma2's kernels at its shapes
(``_gemma2`` timing lines: K1/K2 with its local layers' window 4096 and
softcap 50 over 13 layers' pools on the DSA mix, K5/K6 at 8 x 64, K9 at 1
x 8192 with the window and softcap, K10 at D 2304 / V 256000 with the
final softcap 30, K7 at T 8192; a softcapped line logs SDPA without the
softcap, ``library_ms`` None); gemma2's engine parity (2 layers: one
local, one global, fp32, with and without DSA, on the long prompts with
one of 4600 tokens: the margin rule and every emitted token's logprob
against the plain route's; + DSA again without the final softcap, which
saturates on random weights, so that the margin rule compares tokens);
``[dsa.random] model=yi-6b``: Yi-6B + DSA at 2 layers in fp32 with the
randomized top-k, the engine on the kernel and on the plain route, tokens
equal under the margin rule, and the tokens the noise moved against the
deterministic top-k; ``[rl.parity]`` with scripted rewards that differ
inside each group (nonzero advantages): the step on the kernel and on the
plain route from the same weights, the parameters moved and within
``train_parity``'s bound, for Yi-6B and for Yi-6B + DSA at top-k 32
(deterministic: the same bounds as dense; randomized: gaps recorded, not
held); gemma2-2b served whole (26 layers, bf16) on the DSA mix, as
published and with DSA on its 13 global layers, K1/K2/K5/K6 launches
against ``serve_launches``; gemma2 trained at full width, depth 26 -> 4
(2 local + 2 global), 1 x 8192, fp32: train parity and 5 trainer steps
with and without DSA, and the indexer warm-up (``[train.warmup]``:
``freeze="all_but_indexer"``, 3 steps, every frozen leaf bitwise
unchanged, every indexer leaf moved, the indexer KL on the trainer's
first batch falling); a decode profile of gemma2 + DSA at 8 rows of 2304
tokens.

Then it prints the kernels' JSON line, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Without a GPU, or
without the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0

H100_BYTES_PER_S = 3.35e12       # HBM3, SXM data sheet
# dense: bf16 and TF32 on the tensor cores, fp32 on the CUDA cores
H100_FLOPS = {"bfloat16": 989e12, "tf32": 494.7e12, "float32": 67e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _log(phase: str, **nums) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in nums.items()),
          flush=True)


def path_kernels(cfg, spec_steps=0):
    """The (decode, prefill) kernel wrappers a config's serving path runs:
    K3/K4 for MLA attention (its DSA layers write k_idx and read none),
    K5/K6 for GQA layers with DSA (the global ones) and the token
    selector, K5 and K7 + K8 with the block selector (its spans gather the
    view: K7 scores it, K8 attends where the span is a multiple of the DSA
    block), K1/K2 for GQA layers without (the hybrid's shared block as
    any), and for the hybrid K11's head-shared form, listed with the decode
    kernels (it runs in every step and every span).  With speculation every
    step is a verify span: no decode kernel runs."""
    from repro_torch.kernels.lightning_indexer import kernel as K7
    from repro_torch.kernels.mamba_scan import kernel as K11
    from repro_torch.kernels.paged_attention import kernel as KD
    from repro_torch.kernels.paged_attention import prefill as KP
    from repro_torch.kernels.sparse_attention import kernel as K8
    if cfg.attention_type == "mla":
        dec, pre = [KD.paged_decode_mla], [KP.paged_prefill_mla]
        return ([] if spec_steps else dec), pre
    kinds = set(cfg.attention_pattern) | ({"global"} if cfg.first_k_dense
                                          else set())
    dec, pre = [], []
    if cfg.dsa is None or kinds != {"global"}:
        dec.append(KD.paged_decode_gqa)
        pre.append(KP.paged_prefill_gqa)
    if cfg.dsa is not None and "global" in kinds:
        dec.append(KD.paged_indexer_scores_kernel)
        if cfg.dsa.selector == "block":
            pre += [K7.lightning_indexer, K8.block_sparse_attention]
        else:
            pre.append(KP.paged_prefill_indexer)
    if cfg.family == "hybrid":
        dec.append(K11.mamba_scan_heads)
    return ([] if spec_steps else dec), pre


def _free() -> None:
    """Release what the last phase left on the card before the next one."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn`` with the host taken out:
    ``reps`` calls captured in one CUDA graph (after a call on a side
    stream), replayed once between CUDA events.  A wrapper whose kernel is
    shorter than its Python and ctypes overhead reads that overhead under
    ``cuda_ms``; this is its device time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn``: the wall time of ``calls``
    back-to-back calls with no synchronise between them (the device work
    queues behind; ``calls`` stays below the launch queue's depth), over
    ``calls``.  For a wrapper whose kernel is shorter than its Python and
    ctypes work, this is what sets its time."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / calls * 1e6


# ---------------------------------------------------------------------------
# kernels vs plain versions
# ---------------------------------------------------------------------------

def _pool(gen, nb, bs, kvh, d, dtype, device, layers=1):
    import torch
    shape = (layers * nb, bs, kvh, d)
    k = torch.randn(shape, generator=gen, device=device).to(dtype)
    v = torch.randn(shape, generator=gen, device=device).to(dtype)
    return k, v


def _tables(rng, B, mb, trash, live_blocks):
    """Disjoint shuffled blocks per row (row b owns live_blocks[b]); the
    rest of every row points at the trash block."""
    import numpy as np
    ids = rng.permutation(trash)
    t = np.full((B, mb), trash, np.int32)
    at = 0
    for b, n in enumerate(live_blocks):
        t[b, :n] = ids[at:at + n]
        at += n
    return t


def check_kernels(device="cuda") -> dict:
    """K1/K2 vs plain on ragged rows (Yi-6B's, a gemma2-like and zamba2's
    shared-block shape: 32 heads of 80, G 1; phi-3-vision's 32 heads of
    96, G 1; minitron's G 3, nemotron-4's G 6 and qwen3-moe's G 16 at d
    128, their KV heads as published); returns the max error per
    kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_attention import kernel as K1
    from repro_torch.kernels.paged_attention import prefill as K2
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED)
    worst = {"paged_decode_gqa": 0.0, "paged_prefill_gqa": 0.0}
    shapes = [("yi6b", 4, 8, 128, 0, 0.0), ("gemma2like", 4, 2, 256, 64, 50.0),
              ("zamba2", 32, 1, 80, 0, 0.0), ("phi3", 32, 1, 96, 0, 0.0),
              ("minitron", 8, 3, 128, 0, 0.0),
              ("nemotron4", 8, 6, 128, 0, 0.0),
              ("qwen3moe", 4, 16, 128, 0, 0.0)]
    for name, kvh, G, d, window, softcap in shapes:
        for bs in (16, 8):
            mb = 12
            for dtype in (torch.float32, torch.bfloat16):
                tol = TOL[str(dtype).split(".")[1]]
                # decode: trash row (len 0), 1 token, block edges, deep row
                lens = [0, 1, bs - 1, bs, 2 * bs + 3, mb * bs - 1]
                B = len(lens)
                live = [0] + [l // bs + 1 for l in lens[1:]]
                trash = sum(live)
                kp, vp = _pool(gen, trash + 1, bs, kvh, d, dtype, device)
                tables = torch.from_numpy(
                    _tables(rng, B, mb, trash, live)).to(device)
                sl = torch.tensor(lens, dtype=torch.int32, device=device)
                q = torch.randn((B, kvh, G, d), generator=gen,
                                device=device).to(dtype)
                got = K1.paged_decode_gqa(q, kp, vp, tables, sl,
                                          window=window, softcap=softcap)
                want = K1.paged_decode_gqa_plain(q, kp, vp, tables, sl,
                                                 window=window,
                                                 softcap=softcap)
                err = (got.float() - want.float()).abs().max().item()
                if not torch.isfinite(got).all() or err > tol:
                    raise AssertionError(f"K1 {name} bs={bs} {dtype}: max "
                                         f"err {err} > {tol} or non-finite")
                worst["paged_decode_gqa"] = max(worst["paged_decode_gqa"],
                                                err)
                # span prefill: start 0, mid-block, at a block edge
                S = 37
                starts = [0, bs + bs // 2, 2 * bs, mb * bs - S]
                B = len(starts)
                live = [(s + S - 1) // bs + 1 for s in starts]
                trash = sum(live)
                kp, vp = _pool(gen, trash + 1, bs, kvh, d, dtype, device)
                tables = torch.from_numpy(
                    _tables(rng, B, mb, trash, live)).to(device)
                st = torch.tensor(starts, dtype=torch.int32, device=device)
                q = torch.randn((B, kvh, S * G, d), generator=gen,
                                device=device).to(dtype)
                got = K2.paged_prefill_gqa(q, kp, vp, tables, st, groups=G,
                                           window=window, softcap=softcap)
                want = K2.paged_prefill_gqa_plain(q, kp, vp, tables, st,
                                                  groups=G, window=window,
                                                  softcap=softcap)
                err2 = (got.float() - want.float()).abs().max().item()
                if not torch.isfinite(got).all() or err2 > tol:
                    raise AssertionError(f"K2 {name} bs={bs} {dtype}: max "
                                         f"err {err2} > {tol} or non-finite")
                worst["paged_prefill_gqa"] = max(worst["paged_prefill_gqa"],
                                                 err2)
                _log("kernels", shape=name, block_size=bs,
                     dtype=str(dtype).split(".")[1], k1_max_abs_err=err,
                     k2_max_abs_err=err2, tol=tol)
    return worst


def _latent_pool(gen, nb, bs, lora, rope, dtype, device, layers=1):
    import torch
    c = torch.randn((layers * nb, bs, lora), generator=gen,
                    device=device).to(dtype)
    kr = torch.randn((layers * nb, bs, rope), generator=gen,
                     device=device).to(dtype)
    return c, kr


def _mla_queries(gen, B, rows, lora, rope, dtype, device):
    """q_lat in fp32 (the absorbed query is built in fp32), q_rope in the
    pools' dtype."""
    import torch
    q_lat = torch.randn((B, rows, lora), generator=gen, device=device)
    q_rope = torch.randn((B, rows, rope), generator=gen,
                         device=device).to(dtype)
    return q_lat, q_rope


def check_mla_kernels(device="cuda") -> dict:
    """K3/K4 vs plain on ragged rows at GLM-5 shapes (H 64) and H 16, every
    block size; K3's bf16 tile at the wrapper's parts, at parts 1 and at
    its cap (parts past a short row's rounds hold no key); returns the max
    error per kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_attention import kernel as K3
    from repro_torch.kernels.paged_attention import prefill as K4
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED)
    worst = {"paged_decode_mla": 0.0, "paged_prefill_mla": 0.0}
    L, R, scale = 512, 64, 192 ** -0.5
    for H in (64, 16):
        for bs in (16, 8, 32):
            mb = 12
            for dtype in (torch.float32, torch.bfloat16):
                # decode: trash row (len 0), 1 token, block edges, deep row
                lens = [0, 1, bs - 1, bs, 2 * bs + 3, mb * bs - 1]
                B = len(lens)
                live = [0] + [l // bs + 1 for l in lens[1:]]
                trash = sum(live)
                c, kr = _latent_pool(gen, trash + 1, bs, L, R, dtype, device)
                tables = torch.from_numpy(
                    _tables(rng, B, mb, trash, live)).to(device)
                sl = torch.tensor(lens, dtype=torch.int32, device=device)
                ql, qr = _mla_queries(gen, B, H, L, R, dtype, device)
                want = K3.paged_decode_mla_plain(ql, qr, c, kr, tables, sl,
                                                 scale=scale)
                err = _hold(f"K3 H={H} bs={bs}",
                            K3.paged_decode_mla(ql, qr, c, kr, tables, sl,
                                                scale=scale), want, dtype)
                if dtype == torch.bfloat16:
                    for parts in (1, K3.MAX_MLA_DECODE_PARTS):
                        err = max(err, _hold(
                            f"K3 H={H} bs={bs} parts={parts}",
                            K3.launch_decode_mla(ql, qr, c, kr, tables, sl,
                                                 scale, parts), want, dtype))
                worst["paged_decode_mla"] = max(worst["paged_decode_mla"],
                                                err)
                # span prefill: start 0, mid-block, at a block edge, last
                S = 37
                starts = [0, bs + bs // 2, 2 * bs, mb * bs - S]
                B = len(starts)
                live = [(s + S - 1) // bs + 1 for s in starts]
                trash = sum(live)
                c, kr = _latent_pool(gen, trash + 1, bs, L, R, dtype, device)
                tables = torch.from_numpy(
                    _tables(rng, B, mb, trash, live)).to(device)
                st = torch.tensor(starts, dtype=torch.int32, device=device)
                ql, qr = _mla_queries(gen, B, S * H, L, R, dtype, device)
                err2 = _hold(f"K4 H={H} bs={bs}",
                             K4.paged_prefill_mla(ql, qr, c, kr, tables, st,
                                                  heads=H, scale=scale),
                             K4.paged_prefill_mla_plain(ql, qr, c, kr,
                                                        tables, st, heads=H,
                                                        scale=scale),
                             dtype)
                worst["paged_prefill_mla"] = max(worst["paged_prefill_mla"],
                                                 err2)
                _log("kernels", shape=f"mla_h{H}", block_size=bs,
                     dtype=str(dtype).split(".")[1], k3_max_abs_err=err,
                     k4_max_abs_err=err2, tol=TOL[str(dtype).split(".")[1]])
    worst["paged_prefill_mla"] = max(worst["paged_prefill_mla"],
                                     check_mla_spans(device))
    return worst


def check_mla_spans(device="cuda") -> float:
    """K4 (bf16: the tensor-core tile; fp32: the SIMT body) against its
    plain version over every block size it takes, at H 64 and 16: 8 rows
    of which row 0 is a trash row (no block of its own), spans starting at
    position 1, crossing a block edge, at one, mid-block, after 300 tokens
    and ending at the table's last position; S 37 (ragged tiles: 37 x 64
    and 37 x 16 rows) and the verify span of a speculative round (S 4:
    32 or 8 tiles, which the bf16 wrapper splits into 4 key-range parts),
    and one long row (S 37 at 1003: 37 tiles, 3 parts).  Returns the max
    error."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import prefill as K4
    rng = np.random.default_rng(SEED + 1)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    L, R, scale = 512, 64, 192 ** -0.5
    worst = 0.0
    for H in (64, 16):
        for bs in (8, 16, 32):
            cases = [(S, [0, 1, bs - 2, bs, bs + bs // 2, 3 * bs + 1, 300,
                          48 * bs - S]) for S in (37, 4)] + [(37, [1003])]
            for S, starts in cases:
                B = len(starts)
                mb = (max(starts) + S - 1) // bs + 1
                live = [0] + [(s + S - 1) // bs + 1 for s in starts[1:]] \
                    if B > 1 else [mb]
                trash = sum(live)
                tables = torch.from_numpy(
                    _tables(rng, B, mb, trash, live)).to(device)
                st = torch.tensor(starts, dtype=torch.int32, device=device)
                parts = build.key_split("paged_mla_resources",
                                        (1, L, R), S * H, B, L,
                                        torch.device(device))[0]
                for dtype in (torch.float32, torch.bfloat16):
                    c, kr = _latent_pool(gen, trash + 1, bs, L, R, dtype,
                                         device)
                    ql, qr = _mla_queries(gen, B, S * H, L, R, dtype, device)
                    err = _hold(f"K4 H={H} bs={bs} S={S} B={B}",
                                K4.paged_prefill_mla(ql, qr, c, kr, tables,
                                                     st, heads=H,
                                                     scale=scale),
                                K4.paged_prefill_mla_plain(
                                    ql, qr, c, kr, tables, st, heads=H,
                                    scale=scale), dtype)
                    worst = max(worst, err)
                    _log("kernels", kernel="paged_prefill_mla", heads=H,
                         block_size=bs, S=S, B=B,
                         parts=parts if dtype == torch.bfloat16 else 1,
                         dtype=str(dtype).split(".")[1], max_abs_err=err,
                         tol=TOL[str(dtype).split(".")[1]])
    return worst


# ---------------------------------------------------------------------------
# timing at the serve phase's shapes
# ---------------------------------------------------------------------------

def _gathered(pool, tables, T, groups):
    """The KV of ``tables``' rows as one dense (B, KVH*groups, T, d) tensor,
    KV heads repeated to the query heads: the input the library call is
    handed, made once, outside its timed loop."""
    from repro_torch.core.paging import paged_view
    x = paged_view(pool, tables)[:, :T].transpose(1, 2)
    return x.repeat_interleave(groups, dim=1).contiguous()


def _hold(what, got, want, dtype) -> float:
    """Fail unless the kernel's output is finite and within the stated
    tolerance of its plain version's: max abs error <= TOL[dtype] *
    min(1, max|plain|).  That is the unit-scale atol, made relative when the
    outputs are small: an output row over ~1000 live keys averages them, so
    at the serve shapes |out| is ~0.05 and a bare atol would hide a wrong
    kernel.  Returns the max abs error."""
    import torch
    name = str(dtype).split(".")[1]
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[name] * min(1.0, want.float().abs().max().item())
    if not torch.isfinite(got).all() or err > tol:
        raise AssertionError(f"{what} {name}: max abs err {err} > {tol} "
                             f"or non-finite")
    return err


def time_kernels(cfg, serve_lens, max_prompt, bs, num_blocks, chunk,
                 device="cuda", reps=64, tag="", window=0,
                 softcap=0.0) -> dict:
    """Each kernel over every layer's rows of a full-size layer-major pool
    (as one decode step / prefill chunk of the serve phase reads them), so
    the KV comes from device memory, not the L2 cache.  ``tag`` is appended
    to the result's keys (another model's shapes).  ``window`` and
    ``softcap`` are a local layer's (gemma2's): the bound counts the keys
    the window leaves, and SDPA, which has no softcap, is then timed
    without it (``sdpa_without_softcap_ms``), not as the library call."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.build import DTYPE_CODE
    from repro_torch.kernels.paged_attention import kernel as K1
    from repro_torch.kernels.paged_attention import prefill as K2
    dtype = torch.bfloat16
    L, kvh, d = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // kvh
    item = 2
    stride = num_blocks + 1
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED)
    kp, vp = _pool(gen, stride, bs, kvh, d, dtype, device, layers=L)
    mb = (max(max(serve_lens), max_prompt) + chunk) // bs + 1
    out = {}

    # K1: one decode step's batch
    lens = np.asarray(serve_lens, np.int32)
    B = len(lens)
    live = [int(l) // bs + 1 for l in lens]
    tables = torch.from_numpy(_tables(rng, B, mb, num_blocks, live)).to(device)
    per_layer = [tables + g * stride for g in range(L)]
    sl = torch.from_numpy(lens).to(device)
    q = torch.randn((B, kvh, G, d), generator=gen, device=device).to(dtype)
    parts = K1.decode_parts(DTYPE_CODE[dtype], d, bs, B, kvh, G, mb,
                            q.device.index)[0]
    it = iter(range(10 ** 9))

    opt = dict(window=window, softcap=softcap)

    def k1():
        return K1.paged_decode_gqa(q, kp, vp, per_layer[next(it) % L], sl,
                                   **opt)
    ms = cuda_ms(k1, reps)
    device_ms = graph_ms(k1, reps)
    call_us = host_us(k1)
    plain_ms = cuda_ms(lambda: K1.paged_decode_gqa_plain(
        q, kp, vp, per_layer[next(it) % L], sl, **opt), max(4, reps // 8))
    T = int(lens.max()) + 1
    kv_views = [(_gathered(kp, t, T, G), _gathered(vp, t, T, G))
                for t in per_layer[:8]]
    kv_pos = torch.arange(T, device=device)[None, :]
    mask = kv_pos <= sl[:, None].long()
    if window:
        mask &= kv_pos > sl[:, None].long() - window
    mask = mask[:, None, None, :]
    qs = q.reshape(B, kvh * G, 1, d)

    def sdpa():
        return F.scaled_dot_product_attention(qs, *kv_views[next(it) % 8],
                                              attn_mask=mask)
    lib_ms = cuda_ms(sdpa, reps)
    lib_dev = graph_ms(sdpa, reps)
    del kv_views
    # held against the plain version at these shapes, in bf16 and in fp32
    # (layer 0's blocks: the tables without a layer offset), at the parts
    # the wrapper picks and at parts 1 (no combine pass)
    q32, k32, v32 = q.float(), kp[:stride].float(), vp[:stride].float()
    err = err32 = 0.0
    for qq, kk, vv, dt in ((q, kp, vp, dtype), (q32, k32, v32, torch.float32)):
        want = K1.paged_decode_gqa_plain(qq, kk, vv, tables, sl, **opt)
        e = max(_hold(f"K1 serve-shape parts={parts}",
                      K1.paged_decode_gqa(qq, kk, vv, tables, sl, **opt),
                      want, dt),
                _hold("K1 serve-shape parts=1", K1.launch_decode_gqa(
                    qq, kk, vv, tables, sl, window, softcap, 1), want, dt))
        if dt == dtype:
            err = e
        else:
            err32 = e
    del q32, k32, v32
    seen = lens + 1 if not window else np.minimum(lens + 1, window)
    toks = int(seen.sum())
    nbytes = toks * kvh * d * 2 * item + 2 * q.numel() * item \
        + tables.numel() * 4 + B * 4
    flops = 4 * toks * G * kvh * d
    lib = dict(library_ms=lib_ms, library_device_ms=lib_dev) if not softcap \
        else dict(library_ms=None, sdpa_without_softcap_ms=lib_ms,
                  sdpa_without_softcap_device_ms=lib_dev)
    out["paged_decode_gqa"] = dict(
        ms=ms, device_ms=device_ms, plain_ms=plain_ms,
        library_ms=lib["library_ms"],
        max_abs_err=err, max_abs_err_fp32=err32, bytes=nbytes, flops=flops,
        shape=f"B={B} lens={lens.tolist()} window={window} "
              f"softcap={softcap}",
        extra=dict({k: v for k, v in lib.items() if k != "library_ms"},
                   host_us=call_us, parts=parts,
                   gb_per_s=nbytes / device_ms / 1e6))

    # K2: the last prefill chunk of the longest prompt
    start = ((max_prompt - 1) // chunk) * chunk
    S = max_prompt - start
    live = [(start + S - 1) // bs + 1]
    tables = torch.from_numpy(_tables(rng, 1, mb, num_blocks, live)).to(device)
    per_layer = [tables + g * stride for g in range(L)]
    st = torch.tensor([start], dtype=torch.int32, device=device)
    q = torch.randn((1, kvh, S * G, d), generator=gen, device=device).to(dtype)
    opt = dict(groups=G, window=window, softcap=softcap)
    ms = cuda_ms(lambda: K2.paged_prefill_gqa(
        q, kp, vp, per_layer[next(it) % L], st, **opt), reps // 4)
    device_ms = graph_ms(lambda: K2.paged_prefill_gqa(
        q, kp, vp, per_layer[next(it) % L], st, **opt), reps // 4)
    plain_ms = cuda_ms(lambda: K2.paged_prefill_gqa_plain(
        q, kp, vp, per_layer[next(it) % L], st, **opt), 4)
    T = start + S
    kv_views = [(_gathered(kp, t, T, G), _gathered(vp, t, T, G))
                for t in per_layer[:8]]
    qpos = start + torch.arange(S, device=device)
    kv_pos = torch.arange(T, device=device)[None, :]
    mask = kv_pos <= qpos[:, None]
    if window:
        mask &= kv_pos > qpos[:, None] - window
    qs = q.reshape(1, kvh, S, G, d).permute(0, 1, 3, 2, 4) \
        .reshape(1, kvh * G, S, d)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, *kv_views[next(it) % 8], attn_mask=mask), reps // 4)
    del kv_views
    err = _hold("K2 serve-shape",
                K2.paged_prefill_gqa(q, kp, vp, tables, st, **opt),
                K2.paged_prefill_gqa_plain(q, kp, vp, tables, st, **opt),
                dtype)
    q32, k32, v32 = q.float(), kp[:stride].float(), vp[:stride].float()
    err32 = _hold("K2 serve-shape",
                  K2.paged_prefill_gqa(q32, k32, v32, tables, st, **opt),
                  K2.paged_prefill_gqa_plain(q32, k32, v32, tables, st,
                                             **opt), torch.float32)
    seen = [start + i + 1 if not window else min(start + i + 1, window)
            for i in range(S)]
    keys = sum(seen)
    T_read = T if not window else min(T, window + S - 1)
    nbytes = T_read * kvh * d * 2 * item + 2 * q.numel() * item \
        + tables.numel() * 4 + 4
    flops = 4 * keys * G * kvh * d
    # the fp32 body (the exact parity route) at the same shape, layer 0's
    # blocks only: the fp32 pool of every layer would not fit beside
    fp32_ms = cuda_ms(lambda: K2.paged_prefill_gqa(q32, k32, v32, tables, st,
                                                   **opt), reps // 4)
    fp32_dev = graph_ms(lambda: K2.paged_prefill_gqa(q32, k32, v32, tables,
                                                     st, **opt), reps // 4)
    b32 = 2 * nbytes - tables.numel() * 4 - 4     # fp32 items, same tables
    t_bytes, t_ops = b32 / H100_BYTES_PER_S * 1e3, \
        flops / H100_FLOPS["float32"] * 1e3
    _log("timing", kernel="paged_prefill_gqa", dtype="float32",
         body="gqa_tile (SIMT)", shape=repr(f"B=1 S={S} start={start}"),
         ms=fp32_ms, device_ms=fp32_dev, bound_ms=max(t_bytes, t_ops),
         bound_by="bytes" if t_bytes >= t_ops else "operations",
         tflops=flops / fp32_dev / 1e9, max_abs_err=err32)
    del q32, k32, v32
    out["paged_prefill_gqa"] = dict(
        ms=ms, device_ms=device_ms, plain_ms=plain_ms,
        library_ms=None if softcap else lib_ms,
        max_abs_err=err, max_abs_err_fp32=err32, bytes=nbytes, flops=flops,
        shape=f"B=1 S={S} start={start} window={window} softcap={softcap}",
        extra=dict(sdpa_without_softcap_ms=lib_ms) if softcap else {})
    del kp, vp
    out = {k + tag: v for k, v in out.items()}
    _bounds(out)
    return out


def _bounds(out: dict) -> None:
    """Each kernel's least time on the card (bytes over 3.35 TB/s or flops
    over 989 TFLOP/s, whichever is larger), logged with its times and the
    share of the bound its device time reaches."""
    for name, r in out.items():
        t_bytes = r["bytes"] / H100_BYTES_PER_S * 1e3
        t_ops = r["flops"] / H100_FLOPS["bfloat16"] * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        dev = r.get("device_ms", r["ms"])
        _log("timing", kernel=name, shape=repr(r["shape"]), ms=r["ms"],
             device_ms=r.get("device_ms"), plain_ms=r["plain_ms"],
             library_ms=r["library_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], tflops=r["flops"] / dev / 1e9,
             bound_share=r["bound_ms"] / dev, **r.get("extra", {}),
             max_abs_err=r["max_abs_err"],
             max_abs_err_fp32=r["max_abs_err_fp32"], dtype="bfloat16")


def _latent_views(c, kr, tables, T, heads):
    """The library call's inputs: the latent of ``tables``' rows gathered
    once, k = [c | kr] and v = c, expanded to ``heads`` and made
    contiguous (B, heads, T, ·), outside the timed loop."""
    from repro_torch.core.paging import paged_view
    import torch
    cv = paged_view(c, tables)[:, :T]
    k = torch.cat([cv, paged_view(kr, tables)[:, :T]], dim=-1)
    B = k.shape[0]
    return (k[:, None].expand(B, heads, *k.shape[1:]).contiguous(),
            cv[:, None].expand(B, heads, *cv.shape[1:]).contiguous())


def time_mla_kernels(cfg, serve_lens, max_prompt, bs, num_blocks, chunk,
                     spec=3, device="cuda", reps=64, layers=16) -> dict:
    """K3 and K4 at the GLM-5 serve phase's shapes (K4 at a prefill chunk
    and, as ``paged_prefill_mla_verify``, at the verify span of a
    ``spec``-deep speculative round over the decode batch), each launch on
    another layer of a ``layers``-deep layer-major latent pool (604 MB at
    16 layers of 2049 blocks: larger than the 50 MB L2 cache, as a deeper
    model's pool would be), so the latent comes from device memory.  The
    bf16 lines carry the wrapper's CUDA-event time and the device time of
    the same calls replayed from a CUDA graph; K3's also its wrapper's host
    microseconds a call and its parts, and K3 is held at the wrapper's
    parts and at parts 1 in both dtypes; K4's fp32 body is timed at the
    chunk on a line of its own."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import kernel as K3
    from repro_torch.kernels.paged_attention import prefill as K4
    dtype = torch.bfloat16
    m = cfg.mla
    H, Lr, R = cfg.num_heads, m.kv_lora_dim, m.qk_rope_dim
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    item = 2
    stride = num_blocks + 1
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED)
    c, kr = _latent_pool(gen, stride, bs, Lr, R, dtype, device, layers=layers)
    mb = (max(max(serve_lens), max_prompt) + chunk) // bs + 1
    it = iter(range(10 ** 9))
    out = {}

    # K3: one decode step's batch
    lens = np.asarray(serve_lens, np.int32)
    B = len(lens)
    live = [int(l) // bs + 1 for l in lens]
    tables = torch.from_numpy(_tables(rng, B, mb, num_blocks, live)).to(device)
    per_layer = [tables + g * stride for g in range(layers)]
    sl = torch.from_numpy(lens).to(device)
    ql, qr = _mla_queries(gen, B, H, Lr, R, dtype, device)
    parts = K3.mla_decode_parts(B, H, Lr, R, mb, ql.device.index)[0]

    def k3():
        return K3.paged_decode_mla(ql, qr, c, kr,
                                   per_layer[next(it) % layers], sl,
                                   scale=scale)
    ms = cuda_ms(k3, reps)
    device_ms = graph_ms(k3, reps)
    call_us = host_us(k3)
    plain_ms = cuda_ms(lambda: K3.paged_decode_mla_plain(
        ql, qr, c, kr, per_layer[next(it) % layers], sl, scale=scale),
        max(4, reps // 8))
    T = int(lens.max()) + 1
    views = [_latent_views(c, kr, t, T, H) for t in per_layer[:2]]
    mask = (torch.arange(T, device=device)[None, :]
            <= sl[:, None].long())[:, None, None, :]
    qs = torch.cat([ql.to(dtype), qr], dim=-1)[:, :, None]   # (B, H, 1, ·)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, *views[next(it) % 2], attn_mask=mask, scale=scale), reps)
    del views
    _free()
    # held against the plain version at these shapes, in bf16 (at the
    # wrapper's parts and at parts 1) and in fp32 (layer 0's blocks: the
    # tables without a layer offset)
    want = K3.paged_decode_mla_plain(ql, qr, c, kr, tables, sl, scale=scale)
    err = max(_hold(f"K3 serve-shape parts={parts}",
                    K3.paged_decode_mla(ql, qr, c, kr, tables, sl,
                                        scale=scale), want, dtype),
              _hold("K3 serve-shape parts=1", K3.launch_decode_mla(
                  ql, qr, c, kr, tables, sl, scale, 1), want, dtype))
    c32, kr32, qr32 = c[:stride].float(), kr[:stride].float(), qr.float()
    err32 = _hold("K3 serve-shape",
                  K3.paged_decode_mla(ql, qr32, c32, kr32, tables, sl,
                                      scale=scale),
                  K3.paged_decode_mla_plain(ql, qr32, c32, kr32, tables, sl,
                                            scale=scale), torch.float32)
    toks = int((lens + 1).sum())
    nbytes = toks * (Lr + R) * item + ql.numel() * 4 + qr.numel() * item \
        + B * H * Lr * 4 + tables.numel() * 4 + B * 4
    flops = H * toks * (2 * (Lr + R) + 2 * Lr)
    out["paged_decode_mla"] = dict(
        ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=lib_ms,
        max_abs_err=err, max_abs_err_fp32=err32, bytes=nbytes, flops=flops,
        shape=f"B={B} H={H} lens={lens.tolist()}",
        extra=dict(host_us=call_us, parts=parts,
                   body="mla_tile (tensor cores)",
                   gb_per_s=nbytes / device_ms / 1e6))

    # K4: the last prefill chunk of the longest prompt
    start = ((max_prompt - 1) // chunk) * chunk
    S = max_prompt - start
    live = [(start + S - 1) // bs + 1]
    tables = torch.from_numpy(_tables(rng, 1, mb, num_blocks, live)).to(device)
    per_layer = [tables + g * stride for g in range(layers)]
    st = torch.tensor([start], dtype=torch.int32, device=device)
    ql, qr = _mla_queries(gen, 1, S * H, Lr, R, dtype, device)
    ms = cuda_ms(lambda: K4.paged_prefill_mla(
        ql, qr, c, kr, per_layer[next(it) % layers], st, heads=H,
        scale=scale), reps // 4)
    device_ms = graph_ms(lambda: K4.paged_prefill_mla(
        ql, qr, c, kr, per_layer[next(it) % layers], st, heads=H,
        scale=scale), reps // 4)
    plain_ms = cuda_ms(lambda: K4.paged_prefill_mla_plain(
        ql, qr, c, kr, per_layer[next(it) % layers], st, heads=H,
        scale=scale), 4)
    T = start + S
    views = [_latent_views(c, kr, t, T, H) for t in per_layer[:2]]
    qpos = start + torch.arange(S, device=device)
    mask = torch.arange(T, device=device)[None, :] <= qpos[:, None]
    qs = torch.cat([ql.to(dtype), qr], dim=-1).reshape(1, S, H, Lr + R) \
        .transpose(1, 2)                                      # (1, H, S, ·)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, *views[next(it) % 2], attn_mask=mask, scale=scale), reps // 4)
    del views, qs
    _free()
    err = _hold("K4 serve-shape",
                K4.paged_prefill_mla(ql, qr, c, kr, tables, st, heads=H,
                                     scale=scale),
                K4.paged_prefill_mla_plain(ql, qr, c, kr, tables, st,
                                           heads=H, scale=scale), dtype)
    qr32 = qr.float()
    err32 = _hold("K4 serve-shape",
                  K4.paged_prefill_mla(ql, qr32, c32, kr32, tables, st,
                                       heads=H, scale=scale),
                  K4.paged_prefill_mla_plain(ql, qr32, c32, kr32, tables,
                                             st, heads=H, scale=scale),
                  torch.float32)
    keys = sum(start + i + 1 for i in range(S))
    nbytes = T * (Lr + R) * item + ql.numel() * 4 + qr.numel() * item \
        + S * H * Lr * 4 + tables.numel() * 4 + 4
    flops = H * keys * (2 * (Lr + R) + 2 * Lr)
    # the fp32 body (the exact parity route) at the same shape, layer 0's
    # blocks only
    fp32_ms = cuda_ms(lambda: K4.paged_prefill_mla(
        ql, qr32, c32, kr32, tables, st, heads=H, scale=scale), reps // 4)
    fp32_dev = graph_ms(lambda: K4.paged_prefill_mla(
        ql, qr32, c32, kr32, tables, st, heads=H, scale=scale), reps // 8)
    b32 = nbytes + T * (Lr + R) * 2 + qr.numel() * 2   # fp32 latent, q_rope
    t_bytes, t_ops = b32 / H100_BYTES_PER_S * 1e3, \
        flops / H100_FLOPS["float32"] * 1e3
    _log("timing", kernel="paged_prefill_mla", dtype="float32",
         body="paged_mla_kernel (SIMT)",
         shape=repr(f"B=1 S={S} start={start}"),
         ms=fp32_ms, device_ms=fp32_dev, bound_ms=max(t_bytes, t_ops),
         bound_by="bytes" if t_bytes >= t_ops else "operations",
         tflops=flops / fp32_dev / 1e9, max_abs_err=err32)
    out["paged_prefill_mla"] = dict(
        ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=lib_ms,
        max_abs_err=err, max_abs_err_fp32=err32, bytes=nbytes, flops=flops,
        shape=f"B=1 H={H} S={S} start={start}")
    out["paged_prefill_mla_verify"] = _time_mla_verify(
        c, kr, per_layer, stride, lens, mb, spec, H, Lr, R, scale, rng, gen,
        it, reps, device)
    del c, kr, c32, kr32
    _bounds(out)
    return out


def _time_mla_verify(c, kr, per_layer, stride, lens, mb, spec, H, Lr, R,
                     scale, rng, gen, it, reps, device) -> dict:
    """K4 at a speculative round's verify span: every row of a decode
    batch (live lengths ``lens``) verifies [pending, drafts], S = spec + 1
    tokens at its own start, 32 tiles at GLM-5's heads (B 8, S 4): the
    wrapper splits each tile's key range over parts CTAs.  The library call
    is SDPA over each row's latent gathered to the longest row with a
    per-row causal mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import prefill as K4
    dtype, item = torch.bfloat16, 2
    bs = c.shape[1]
    B, S = len(lens), spec + 1
    layers = len(per_layer)
    live = [(int(n) + S - 1) // bs + 1 for n in lens]
    tables = torch.from_numpy(_tables(rng, B, mb, stride - 1, live)).to(device)
    layered = [tables + g * stride for g in range(layers)]
    st = torch.from_numpy(lens.astype("int32")).to(device)
    ql, qr = _mla_queries(gen, B, S * H, Lr, R, dtype, device)

    def call(t):
        return K4.paged_prefill_mla(ql, qr, c, kr, t, st, heads=H,
                                    scale=scale)
    ms = cuda_ms(lambda: call(layered[next(it) % layers]), reps)
    device_ms = graph_ms(lambda: call(layered[next(it) % layers]), reps // 2)
    plain_ms = cuda_ms(lambda: K4.paged_prefill_mla_plain(
        ql, qr, c, kr, layered[next(it) % layers], st, heads=H, scale=scale),
        4)
    T = int(lens.max()) + S
    views = [_latent_views(c, kr, t, T, H) for t in layered[:2]]
    qpos = st[:, None].long() + torch.arange(S, device=device)[None]
    mask = (torch.arange(T, device=device)[None, None, :]
            <= qpos[..., None])[:, None]                     # (B, 1, S, T)
    qs = torch.cat([ql.to(dtype), qr], dim=-1).reshape(B, S, H, Lr + R) \
        .transpose(1, 2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, *views[next(it) % 2], attn_mask=mask, scale=scale), reps)
    del views, qs
    _free()
    err = _hold("K4 verify-shape", call(tables),
                K4.paged_prefill_mla_plain(ql, qr, c, kr, tables, st,
                                           heads=H, scale=scale), dtype)
    c32, kr32, qr32 = c[:stride].float(), kr[:stride].float(), qr.float()
    err32 = _hold("K4 verify-shape",
                  K4.paged_prefill_mla(ql, qr32, c32, kr32, tables, st,
                                       heads=H, scale=scale),
                  K4.paged_prefill_mla_plain(ql, qr32, c32, kr32, tables,
                                             st, heads=H, scale=scale),
                  torch.float32)
    keys = int(sum(int(n) + i + 1 for n in lens for i in range(S)))
    toks = int(sum(int(n) + S for n in lens))
    nbytes = toks * (Lr + R) * item + ql.numel() * 4 + qr.numel() * item \
        + ql.numel() * 4 + tables.numel() * 4 + B * 4
    return dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                library_ms=lib_ms, max_abs_err=err, max_abs_err_fp32=err32,
                bytes=nbytes, flops=H * keys * (2 * (Lr + R) + 2 * Lr),
                shape=f"B={B} H={H} S={S} lens={lens.tolist()}")


def mla_resources(cfg, batch, mb) -> None:
    """K3/K4's registers, spills, shared memory and CTAs resident on one SM,
    as the CUDA runtime reports them for each body (fp32: the SIMT body;
    bf16: the tensor-core tile), beside the parts and CTAs K3 launches for
    one decode step of ``batch`` rows over ``mb`` blocks and the card's
    SMs."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import kernel as K3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    H, L, R = cfg.num_heads, cfg.mla.kv_lora_dim, cfg.mla.qk_rope_dim
    for code, dtype, body in ((0, "float32", "paged_mla_kernel (SIMT)"),
                              (1, "bfloat16", "mla_tile (tensor cores)")):
        regs, spill, smem, ctas, rows = build.resources(
            "paged_mla_resources", code, L, R)
        parts = K3.mla_decode_parts(batch, H, L, R, mb,
                                    torch.cuda.current_device())[0] \
            if code else 1
        _log("resources", kernel="paged_mla", dtype=dtype, body=body,
             registers=regs, spill_bytes=spill, smem_bytes=smem,
             ctas_per_sm=ctas, rows_per_cta=rows, decode_parts=parts,
             decode_ctas=batch * -(-H // rows) * parts, sms=sms)


def tile_resources(gqa_cfg, block_cfg, span, mla_cfg, batch, spec,
                   train_cfg, decode_mb) -> None:
    """The tensor-core attention tiles at the serve and training shapes:
    the bf16 tile of K2 and K8 (csrc/mma_tile.cuh; ``gqa_cfg``'s heads over
    blocks of 16, and ``block_cfg``'s over its DSA blocks, spans of
    ``span`` tokens), K4's bf16 MLA tile (csrc/paged_mla.cu; ``mla_cfg``'s
    heads at a ``span``-token chunk and at a ``spec``-deep verify span of
    ``batch`` rows), the fp32 3xTF32 tile (csrc/tf32_tile.cuh) of K9 (every
    head dim, the grid of ``train_cfg``'s layer at batch 2 x 2048) and of
    K8 (``block_cfg``'s training chunk and GLM-5's MLA 192 / 256), K1's
    split-KV body (``gqa_cfg``'s heads, ``batch`` rows over ``decode_mb``
    blocks of 16) and K10's logits tiles (fp32 by 3xTF32, bf16 SIMT, at
    ``train_cfg``'s vocabulary): registers, spills, shared memory and CTAs
    resident on one SM as the CUDA runtime reports them, the rows a CTA and
    the key-range parts the wrapper picks; then the HMMA (tensor-core)
    instructions of every instantiation of the tiles in the built
    libraries, from ``cuobjdump -sass`` (K8's, K9's, K10's and K7's fp32
    tiles' must be HMMA .TF32 and the bf16 ones' not; K1's bf16 body, K3's
    and K4's tile (one kernel) and the indexer tensor-core bodies, K5's
    decode form, K6's and K7's span body, are among them; it fails where an
    instantiation has none; where the tool is missing it says so)."""
    import re
    import shutil
    import torch
    from repro_torch.kernels import build
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    d, kvh = gqa_cfg.head_dim, gqa_cfg.num_kv_heads
    bs = block_cfg.dsa.block_size
    dk = block_cfg.head_dim
    Gb = block_cfg.num_heads // block_cfg.num_kv_heads
    H, L, R = mla_cfg.num_heads, mla_cfg.mla.kv_lora_dim, \
        mla_cfg.mla.qk_rope_dim
    cases = [("paged_prefill_gqa", "mma_tile", "paged_prefill_gqa_resources",
              (d, 16), span * (gqa_cfg.num_heads // kvh), kvh, d, "serve"),
             ("block_sparse_attention", "mma_tile", "block_sparse_resources",
              (1, dk, dk), bs * Gb, span // bs * block_cfg.num_kv_heads, dk,
              "serve"),
             ("block_sparse_attention", "tf32_tile", "block_sparse_resources",
              (0, dk, dk), bs * Gb, span // bs * block_cfg.num_kv_heads, dk,
              "train"),
             ("block_sparse_attention", "tf32_tile", "block_sparse_resources",
              (0, 192, 256), bs, span // bs * 64, 256, "glm5_mla"),
             ("paged_prefill_mla", "mla_span_kernel",
              "paged_mla_resources", (1, L, R), span * H, 1, L, "serve"),
             ("paged_prefill_mla", "mla_span_kernel",
              "paged_mla_resources", (1, L, R), (spec + 1) * H, batch, L,
              "verify")]
    for kernel, body, query, args, rows, others, dv, at in cases:
        regs, spill, smem, ctas, per_cta = build.resources(query, *args)
        parts = build.key_split(query, args, rows, others, dv, dev)[0]
        _log("resources", kernel=kernel,
             dtype="float32" if body == "tf32_tile" else "bfloat16",
             body=body, instance="x".join(map(str, args[-2:])), shape=at,
             registers=regs,
             spill_bytes=spill, smem_bytes=smem, ctas_per_sm=ctas,
             rows_per_cta=per_cta, tiles=-(-rows // per_cta) * others,
             parts=parts, sms=sms)
    # K1's split-KV body (no tensor cores) at the decode step's shape
    from repro_torch.kernels.paged_attention import kernel as K1
    G1 = gqa_cfg.num_heads // kvh
    for dtype, code in (("float32", 0), ("bfloat16", 1)):
        regs, spill, smem, ctas, per_cta = build.resources(
            "paged_decode_gqa_resources", code, d, 16)
        _log("resources", kernel="paged_decode_gqa", dtype=dtype,
             body="decode_split::" + ("simt_kernel" if code == 0
                                      else "mma_kernel (tensor cores)"),
             instance=f"{d}x16",
             shape="serve", registers=regs, spill_bytes=spill,
             smem_bytes=smem, ctas_per_sm=ctas, rows_per_cta=per_cta,
             tiles=batch * kvh * -(-G1 // per_cta),
             parts=K1.decode_parts(code, d, 16, batch, kvh, G1, decode_mb,
                                   dev.index)[0], sms=sms)
    # K10's logits tile: fp32 by 3xTF32, bf16 on the CUDA cores
    for dtype, code, body in (("float32", 0, "ce_tf32 (3xTF32)"),
                              ("bfloat16", 1, "ce_tile_kernel (SIMT)")):
        regs, spill, smem, ctas, per_cta = build.resources(
            "chunked_ce_resources", code)
        _log("resources", kernel="chunked_ce", dtype=dtype, body=body,
             registers=regs, spill_bytes=spill, smem_bytes=smem,
             ctas_per_sm=ctas, tokens_per_cta=per_cta,
             train_tiles=-(-2 * 2048 // per_cta)
             * -(-train_cfg.vocab_size // 128), sms=sms)
    G = train_cfg.num_heads // train_cfg.num_kv_heads
    for hd in (64, 80, 128, 256):
        regs, spill, smem, ctas, per_cta = build.resources(
            "flash_attention_resources", 0, hd)
        _log("resources", kernel="flash_attention", dtype="float32",
             body="tf32_tile (3xTF32)", instance=hd, registers=regs,
             spill_bytes=spill, smem_bytes=smem, ctas_per_sm=ctas,
             rows_per_cta=per_cta,
             train_tiles=-(-2048 * G // per_cta) * train_cfg.num_kv_heads * 2
             if hd == train_cfg.head_dim else None, sms=sms)
    # K9's bf16 tile, with the parts its wrapper picks at the RL loop
    # backend's re-forward (B 1, 240 tokens of the training config's heads)
    from repro_torch.kernels.flash_attention import kernel as K9
    for hd in (64, 80, 128, 256):
        regs, spill, smem, ctas, per_cta = build.resources(
            "flash_attention_resources", 1, hd)
        loop_rows = 240 * G
        _log("resources", kernel="flash_attention", dtype="bfloat16",
             body="mma_tile::attention_kernel<DenseKV>", instance=hd,
             registers=regs, spill_bytes=spill, smem_bytes=smem,
             ctas_per_sm=ctas, rows_per_cta=per_cta,
             loop_tiles=-(-loop_rows // per_cta) * train_cfg.num_kv_heads,
             loop_parts=K9.bf16_parts(hd, loop_rows, train_cfg.num_kv_heads,
                                      dev), sms=sms)
    tool = shutil.which("cuobjdump") or str(Path(build.nvcc()).parent
                                            / "cuobjdump")
    if not Path(tool).exists():
        _log("sass", cuobjdump="missing")
        return
    # (library, the parts of a name that mark the tile's kernels, whether
    # every HMMA must be .TF32: the fp32 tiles)
    tile, tf32 = ("mma_tile", "attention_kernel"), ("tf32_tile",
                                                    "attention_kernel")
    for lib, marks, tf32_only in (
            ("paged_attention", tile, False), ("block_sparse", tile, False),
            ("block_sparse", tf32, True), ("paged_mla", ("mla_span_kernel",),
                                           False),
            ("flash_attention", tile, False),
            ("paged_indexer", ("indexer_mma", "decode_kernel"), False),
            ("flash_attention", tf32, True),
            ("chunked_ce", ("ce_tf32", "tile_kernel"), True),
            ("paged_attention", ("decode_split", "mma_kernel"), False),
            ("paged_indexer", ("indexer_mma", "span_kernel"), False),
            ("lightning_indexer", ("span_kernelI13__nv_bfloat16",), False),
            ("lightning_indexer", ("span_kernelIf",), True)):
        sass = subprocess.run([tool, "-sass", str(build.library_path(lib))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        counts, name = {}, None
        for line in sass.splitlines():
            found = re.search(r"Function : (\S+)", line)
            if found:
                name = found.group(1)
                if all(m in name for m in marks):
                    counts[name] = [0, 0]
            elif name in counts and "HMMA" in line:
                counts[name][0] += 1
                counts[name][1] += ".TF32" in line
        for name, (n, n_tf32) in counts.items():
            dims = re.search(r"(?:attention|span)_kernelI(?:13__nv_bfloat16|f)?"
                             r"Li(\d+)ELi(\d+)E", name)
            page = re.search(r"PagedSpanILi(\d+)E", name)
            if lib == "paged_mla":
                label = "mla_span_kernel (K3 decode, K4 span)"
            elif lib == "chunked_ce":
                label = "ce_tf32::tile_kernel"
            elif "decode_split" in name:
                label = "decode_split::mma_kernel<{},{}>".format(*re.search(
                    r"mma_kernelILi(\d+)ELi(\d+)E", name).groups())
            elif "decode_kernel" in name:
                label = "indexer_mma::decode_kernel<{},{},PagedKeys>".format(
                    *re.search(r"decode_kernelILi(\d+)ELi(\d+)E",
                               name).groups())
            elif lib in ("paged_indexer", "lightning_indexer"):
                label = "indexer_mma::span_kernel<{},{},{},{}>".format(
                    "float" if tf32_only else "bf16", dims[1], dims[2],
                    "PagedKeys" if lib == "paged_indexer" else "DenseKeys")
            else:
                label = (f"{marks[0]}::attention_kernel<{dims[1]},{dims[2]},"
                         + (f"PagedSpan<{page[1]}>>" if page else
                            "DenseKV>" if lib == "flash_attention"
                            else "SelectedBlocks>"))
            _log("sass", library=lib, kernel=label, hmma=n, hmma_tf32=n_tf32)
            if n == 0 or (tf32_only and n_tf32 != n) \
                    or (not tf32_only and n_tf32):
                raise AssertionError(f"{lib} {label}: {n} HMMA instructions, "
                                     f"{n_tf32} of them .TF32")
        if not counts:
            raise AssertionError(f"{lib}: no tensor-core tile in its SASS")


# ---------------------------------------------------------------------------
# K5/K6: the DSA indexer kernels
# ---------------------------------------------------------------------------

INDEXER_SHAPES = (("yi6b", 16, 64), ("glm5", 32, 128))   # (Hi, Di)
ZAMBA2_INDEXER = ("zamba2", 8, 64)   # one n-tile of heads (K5, K6, K7)
MINITRON_INDEXER = ("minitron", 12, 64)   # no tensor-core body: SIMT tile


def _indexer_pool(gen, nb, bs, Di, dtype, device, layers=1):
    import torch
    return torch.randn((layers * nb, bs, Di), generator=gen,
                       device=device).to(dtype)


def _indexer_queries(gen, B, rows, heads, Di, dtype, device):
    """q_idx (B, rows, Di) in the pool's dtype, softmaxed head weights
    (B, rows) in fp32, rows packed ``i*heads + h``."""
    import torch
    q = torch.randn((B, rows, Di), generator=gen, device=device).to(dtype)
    w = torch.softmax(torch.randn((B, rows // heads, heads), generator=gen,
                                  device=device), dim=-1)
    return q, w.reshape(B, rows)


def _hold_scores(what, got, want, dtype) -> float:
    """``_hold`` for indexer scores: the dead blocks (<= -1e29) must be the
    same in both, and the live scores within the tolerance."""
    dead = want <= -1e29
    if not bool((got <= -1e29).eq(dead).all()):
        raise AssertionError(f"{what}: dead blocks differ")
    return _hold(what, got.masked_fill(dead, 0.0), want.masked_fill(dead, 0.0),
                 dtype)


def check_indexer_kernels(device="cuda") -> dict:
    """K5/K6 vs plain on ragged rows at Yi-6B's (Hi 16, Di 64), GLM-5's
    (Hi 32, Di 128), zamba2's (Hi 8, Di 64) and minitron's (Hi 12, Di 64)
    indexer shapes (bf16: their tensor-core bodies, at 8 heads one n-tile,
    at 12 the SIMT tile; fp32: the SIMT tile),
    every block size, the spans with an idle slot (a row whose table is all
    the trash block) and dead blocks; returns the max error per kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_attention import kernel as K5
    from repro_torch.kernels.paged_attention import prefill as K6
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED)
    worst = {"paged_indexer_scores_kernel": 0.0,
             "paged_prefill_indexer": 0.0}
    for name, Hi, Di in INDEXER_SHAPES + (ZAMBA2_INDEXER,
                                          MINITRON_INDEXER):
        for bs in (16, 8, 32):
            mb = 20                       # 160-640 positions: 2-5 tiles
            for dtype in (torch.float32, torch.bfloat16):
                # decode: trash row (len 0), 1 token, block edges, deep rows
                lens = [0, 1, bs - 1, bs, 2 * bs + 3, 130, mb * bs - 1]
                B = len(lens)
                live = [0] + [l // bs + 1 for l in lens[1:]]
                trash = sum(live)
                kp = _indexer_pool(gen, trash + 1, bs, Di, dtype, device)
                tables = torch.from_numpy(
                    _tables(rng, B, mb, trash, live)).to(device)
                sl = torch.tensor(lens, dtype=torch.int32, device=device)
                q, w = _indexer_queries(gen, B, Hi, Hi, Di, dtype, device)
                err = _hold_scores(
                    f"K5 {name} bs={bs}",
                    K5.paged_indexer_scores_kernel(q, w, kp, tables, sl),
                    K5.paged_indexer_scores_plain(q, w, kp, tables, sl),
                    dtype)
                worst["paged_indexer_scores_kernel"] = max(
                    worst["paged_indexer_scores_kernel"], err)
                # span: an idle slot, start 0, mid-block, at a block edge,
                # deep, last
                S = 37
                starts = [0, 0, bs + bs // 2, 2 * bs, 100, mb * bs - S]
                B = len(starts)
                live = [0] + [(s + S - 1) // bs + 1 for s in starts[1:]]
                trash = sum(live)
                kp = _indexer_pool(gen, trash + 1, bs, Di, dtype, device)
                tables = torch.from_numpy(
                    _tables(rng, B, mb, trash, live)).to(device)
                st = torch.tensor(starts, dtype=torch.int32, device=device)
                q, w = _indexer_queries(gen, B, S * Hi, Hi, Di, dtype,
                                        device)
                err2 = _hold_scores(
                    f"K6 {name} bs={bs}",
                    K6.paged_prefill_indexer(q, w, kp, tables, st, heads=Hi),
                    K6.paged_prefill_indexer_plain(q, w, kp, tables, st,
                                                   heads=Hi), dtype)
                worst["paged_prefill_indexer"] = max(
                    worst["paged_prefill_indexer"], err2)
                _log("kernels", shape=f"indexer_{name}", block_size=bs,
                     dtype=str(dtype).split(".")[1], k5_max_abs_err=err,
                     k6_max_abs_err=err2, tol=TOL[str(dtype).split(".")[1]])
    return worst


def _topk_boundary(what, got, want, qpos, k, tol, noise=None) -> int:
    """Score rows (R, T) and each row's query position: the top-k sets that
    ``select_topk`` (causal mask, stable sort) chooses from the kernel's
    and from the plain version's scores may differ only at indices whose
    plain score lies within ``tol`` of the k-th plain score (a near-tie
    the summation order can flip).  With ``noise`` (R, T) (the randomized
    top-k's) both selections add it, and the k-th score is of the plain
    scores plus it.  Raises on any other difference; returns the count of
    such near-tie indices."""
    import torch
    from repro_torch.core.dsa import select_topk
    R, T = want.shape
    mask = torch.arange(T, device=want.device)[None, :] <= qpos[:, None]
    extra = None if noise is None else noise[:, None]

    def chosen(scores):
        idx, valid = select_topk(scores[:, None], mask[:, None], k, extra)
        sel = torch.zeros((R, T), dtype=torch.bool, device=want.device)
        return sel.scatter_(1, idx[:, 0], valid[:, 0])
    diff = chosen(got) ^ chosen(want)
    if noise is not None:
        want = want + noise
    masked = torch.where(mask, want, float("-inf"))
    kth = masked.topk(min(k, T), dim=-1).values[:, -1:]
    far = diff & ((want - kth).abs() > tol)
    if bool(far.any()):
        raise AssertionError(f"{what}: top-{k} sets differ at "
                             f"{int(far.sum())} indices away from the k-th "
                             f"score")
    return int(diff.sum())


def time_indexer_kernels(cfg, serve_lens, span_start, span_len, bs,
                         num_blocks, mb, device="cuda", reps=64,
                         tag="") -> dict:
    """K5 at one decode step of the DSA serve phase (B = 8 rows at its
    lengths) and K6 at one 256-token span whose last position lies past
    2048, each launch on another layer of a full-depth layer-major k_idx
    pool; each held against its plain version (bf16 and fp32) with its
    top-k sets compared, deterministic and randomized (the same
    ``topk_noise`` draw added to both: ``[dsa.random]`` lines); both
    (their bf16 tensor-core bodies) also with
    their device time from CUDA-graph replay and their wrappers' host
    microseconds a call (the SIMT tile at head counts the bodies do not
    take: they take 8, 16 or 32).  No single
    PyTorch call computes ReLU between the product and the head sum, so
    there is no library time.  ``tag`` is appended to the result's keys."""
    import numpy as np
    import torch
    from repro_torch.core.dsa import topk_noise
    from repro_torch.kernels.paged_attention import kernel as K5
    from repro_torch.kernels.paged_attention import prefill as K6
    dtype = torch.bfloat16
    Hi, Di, top_k = cfg.dsa.index_heads, cfg.dsa.index_head_dim, \
        cfg.dsa.top_k
    # the tensor-core bodies' head counts (K5's decode form, K6's span)
    k5_mma = k6_mma = Hi in (8, 16, 32)
    L, item = cfg.num_layers, 2
    stride = num_blocks + 1
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED)
    kp = _indexer_pool(gen, stride, bs, Di, dtype, device, layers=L)
    it = iter(range(10 ** 9))
    out = {}

    # K5: one decode step's batch
    lens = np.asarray(serve_lens, np.int32)
    B = len(lens)
    live = [int(l) // bs + 1 for l in lens]
    tables = torch.from_numpy(_tables(rng, B, mb, num_blocks, live)).to(device)
    per_layer = [tables + g * stride for g in range(L)]
    sl = torch.from_numpy(lens).to(device)
    q, w = _indexer_queries(gen, B, Hi, Hi, Di, dtype, device)

    def k5():
        return K5.paged_indexer_scores_kernel(q, w, kp,
                                              per_layer[next(it) % L], sl)
    ms = cuda_ms(k5, reps)
    device_ms = graph_ms(k5, reps)
    call_us = host_us(k5)
    plain_ms = cuda_ms(lambda: K5.paged_indexer_scores_plain(
        q, w, kp, per_layer[next(it) % L], sl), max(4, reps // 8))
    got = K5.paged_indexer_scores_kernel(q, w, kp, tables, sl)
    want = K5.paged_indexer_scores_plain(q, w, kp, tables, sl)
    err = _hold_scores("K5 serve-shape", got, want, dtype)
    tol = TOL["bfloat16"] * min(1.0, want.abs().max().item())
    near = _topk_boundary("K5 serve-shape", got, want, sl.long(), top_k, tol)
    # the randomized top-k: both selections add the same noise, the decode
    # step's (B, 1, T) draw
    near_random = _topk_boundary(
        "K5 serve-shape, randomized top-k", got, want, sl.long(), top_k, tol,
        noise=topk_noise((B, 1, want.shape[-1]), want.device)[:, 0])
    q32, k32 = q.float(), kp[:stride].float()
    err32 = _hold_scores("K5 serve-shape",
                         K5.paged_indexer_scores_kernel(q32, w, k32, tables,
                                                        sl),
                         K5.paged_indexer_scores_plain(q32, w, k32, tables,
                                                       sl), torch.float32)
    toks = sum(live) * bs                 # whole live blocks are scored
    nbytes = toks * Di * item + q.numel() * item + w.numel() * 4 \
        + B * mb * bs * 4 + tables.numel() * 4 + B * 4
    out["paged_indexer_scores_kernel"] = dict(
        ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=None,
        max_abs_err=err, max_abs_err_fp32=err32, bytes=nbytes,
        flops=toks * Hi * (2 * Di + 2), topk_near_ties=near,
        topk_near_ties_random=near_random,
        extra=dict(host_us=call_us,
                   body="indexer_mma::decode_kernel (tensor cores)"
                   if k5_mma else "indexer_tile (SIMT)",
                   gb_per_s=nbytes / device_ms / 1e6),
        shape=f"B={B} Hi={Hi} Di={Di} lens={lens.tolist()}")

    # K6: one prefill span of the longest prompt
    S, start = span_len, span_start
    n_live = (start + S - 1) // bs + 1
    tables = torch.from_numpy(
        _tables(rng, 1, mb, num_blocks, [n_live])).to(device)
    per_layer = [tables + g * stride for g in range(L)]
    st = torch.tensor([start], dtype=torch.int32, device=device)
    q, w = _indexer_queries(gen, 1, S * Hi, Hi, Di, dtype, device)
    ms = cuda_ms(lambda: K6.paged_prefill_indexer(
        q, w, kp, per_layer[next(it) % L], st, heads=Hi), reps // 4)
    device_ms = graph_ms(lambda: K6.paged_prefill_indexer(
        q, w, kp, per_layer[next(it) % L], st, heads=Hi), reps // 4)
    host = host_us(lambda: K6.paged_prefill_indexer(
        q, w, kp, per_layer[next(it) % L], st, heads=Hi), 100)
    plain_ms = cuda_ms(lambda: K6.paged_prefill_indexer_plain(
        q, w, kp, per_layer[next(it) % L], st, heads=Hi), 4)
    got = K6.paged_prefill_indexer(q, w, kp, tables, st, heads=Hi)
    want = K6.paged_prefill_indexer_plain(q, w, kp, tables, st, heads=Hi)
    err = _hold_scores("K6 serve-shape", got, want, dtype)
    tol = TOL["bfloat16"] * min(1.0, want.abs().max().item())
    qpos = start + torch.arange(S, device=device)
    near = _topk_boundary("K6 serve-shape", got[0], want[0], qpos, top_k, tol)
    near_random = _topk_boundary(
        "K6 serve-shape, randomized top-k", got[0], want[0], qpos, top_k,
        tol, noise=topk_noise((1, S, want.shape[-1]), want.device)[0])
    q32 = q.float()
    err32 = _hold_scores("K6 serve-shape",
                         K6.paged_prefill_indexer(q32, w, k32, tables, st,
                                                  heads=Hi),
                         K6.paged_prefill_indexer_plain(q32, w, k32, tables,
                                                        st, heads=Hi),
                         torch.float32)
    del kp, k32
    toks = n_live * bs
    nbytes = toks * Di * item + q.numel() * item + w.numel() * 4 \
        + S * mb * bs * 4 + tables.numel() * 4 + 4
    out["paged_prefill_indexer"] = dict(
        ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=None,
        max_abs_err=err, max_abs_err_fp32=err32, bytes=nbytes,
        flops=S * toks * Hi * (2 * Di + 2), topk_near_ties=near,
        topk_near_ties_random=near_random,
        extra=dict(host_us=host,
                   body="indexer_mma::span_kernel (tensor cores)" if k6_mma
                   else "indexer_tile (SIMT)"),
        shape=f"B=1 Hi={Hi} Di={Di} S={S} start={start}")
    out = {k + tag: v for k, v in out.items()}
    for name, r in out.items():
        _log("topk", kernel=name, k=top_k,
             near_tie_indices_differing=r["topk_near_ties"])
        _log("dsa.random", kernel=name, k=top_k,
             near_tie_indices_differing=r["topk_near_ties_random"])
    _bounds(out)
    return out


def indexer_resources(cfg, batch, max_len, bs) -> None:
    """K5/K6's registers, spills, shared memory and CTAs resident on one SM,
    as the CUDA runtime reports them: the SIMT tile (fp32 K5 and K6) at the
    config's indexer shape; the tensor-core bodies at both indexer shapes:
    K5's decode form (bf16, paged keys) beside the CTAs it launches for one
    decode step of ``batch`` rows over ``max_len`` positions, K6's span
    body (bf16, paged keys) and K7's (bf16 and fp32 by 3xTF32, dense
    keys)."""
    import torch
    from repro_torch.kernels import build
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    Hi, Di = cfg.dsa.index_heads, cfg.dsa.index_head_dim
    regs, spill, smem, ctas, toks = build.resources(
        "paged_indexer_resources", 0, Di, Hi)
    _log("resources", kernel="paged_indexer", heads=Hi, index_dim=Di,
         dtype="float32", body="indexer_tile (SIMT)", registers=regs,
         spill_bytes=spill, smem_bytes=smem, ctas_per_sm=ctas,
         tokens_per_cta=toks, sms=sms)
    # K5's bf16 decode form at the three indexer shapes (zamba2's: one
    # n-tile of heads)
    for name, heads, dim in INDEXER_SHAPES + (ZAMBA2_INDEXER,):
        regs, spill, smem, ctas, per_cta = build.resources(
            "paged_indexer_scores_resources", heads, dim)
        _log("resources", kernel="paged_indexer_scores_kernel", shape=name,
             heads=heads, index_dim=dim, dtype="bfloat16",
             body="indexer_mma::decode_kernel (tensor cores)",
             registers=regs, spill_bytes=spill, smem_bytes=smem,
             ctas_per_sm=ctas, positions_per_cta=per_cta,
             decode_ctas=batch * -(-(max_len // bs * bs) // per_cta),
             sms=sms)
    # K6's bf16 tensor-core body at the three indexer shapes (zamba2's: one
    # n-tile of heads)
    for name, heads, dim in INDEXER_SHAPES + (ZAMBA2_INDEXER,):
        regs, spill, smem, ctas, toks = build.resources(
            "paged_prefill_indexer_resources", heads, dim)
        _log("resources", kernel="paged_prefill_indexer", shape=name,
             heads=heads, index_dim=dim, dtype="bfloat16",
             body="indexer_mma (tensor cores)", registers=regs,
             spill_bytes=spill, smem_bytes=smem, ctas_per_sm=ctas,
             tokens_per_cta=toks, sms=sms)
    # K7's routes on the same body over dense keys: bf16, fp32 by 3xTF32
    for name, heads, dim in INDEXER_SHAPES + (ZAMBA2_INDEXER,):
        for dtype, code in (("bfloat16", 1), ("float32", 0)):
            regs, spill, smem, ctas, toks = build.resources(
                "lightning_indexer_resources", code, heads, dim)
            _log("resources", kernel="lightning_indexer", shape=name,
                 heads=heads, index_dim=dim, dtype=dtype,
                 body="indexer_mma (tensor cores"
                      + (", 3xTF32)" if code == 0 else ")"),
                 registers=regs, spill_bytes=spill, smem_bytes=smem,
                 ctas_per_sm=ctas, tokens_per_cta=toks, sms=sms)


# ---------------------------------------------------------------------------
# K8: block-sparse attention (the DSA block selector)
# ---------------------------------------------------------------------------

# (name, B, S, H, KVH, dqk, dv, block size, blocks a query block, T)
K8_SHAPES = (("yi6b", 1, 256, 32, 4, 128, 128, 128, 16, 6144),
             ("glm5_mla", 1, 256, 64, 64, 192, 256, 128, 16, 4096),
             ("smoke", 2, 64, 4, 2, 64, 64, 16, 4, 256))


def _k8_inputs(gen, rng, shape, dtype, device, skipped=0.3):
    """q/k/v of a K8 shape; per (row, query block) distinct key blocks, a
    ``skipped`` share of them negative (skipped, standing for block -id-1),
    every id of row 0's first query block skipped (its queries see no key);
    row b's queries from T - S - 7b (mid-sequence)."""
    import numpy as np
    import torch
    _, B, S, H, KVH, dqk, dv, bs, nb, T = shape
    q = torch.randn((B, S, H, dqk), generator=gen, device=device).to(dtype)
    k = torch.randn((B, T, KVH, dqk), generator=gen, device=device).to(dtype)
    v = torch.randn((B, T, KVH, dv), generator=gen, device=device).to(dtype)
    ids = np.stack([[rng.permutation(T // bs)[:nb] for _ in range(S // bs)]
                    for _ in range(B)])
    ids = np.where(rng.random(ids.shape) < skipped, -ids - 1, ids)
    ids[0, 0] = -np.abs(ids[0, 0]) - 1
    ids = torch.from_numpy(ids.astype(np.int32)).to(device)
    start = torch.tensor([T - S - 7 * b for b in range(B)],
                         dtype=torch.int32, device=device)
    return q, k, v, ids, start


def check_sparse_kernels(device="cuda") -> dict:
    """K8 against its plain version at Yi-6B's shape (H 32 / KVH 4, d 128,
    blocks of 128, 16 a query block), GLM-5's MLA shape (H 64, dqk 192, dv
    256) and the smoke shape (blocks of 16, 4 a query block): queries from
    mid-sequence, skipped ids, softcap 0 and 50, both rules for a query
    that sees no key, fp32 (atol 1e-4) and bf16 (2e-2), scaled by
    min(1, max|plain|); then the gradients through ``sparse_block_
    attention``'s autograd Function on the kernel and plain routes."""
    import numpy as np
    import torch
    from repro_torch.core import dsa as dsa_mod
    from repro_torch.kernels.sparse_attention import kernel as K8
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=device).manual_seed(SEED)
    worst = 0.0
    for shape in K8_SHAPES:
        bs = shape[7]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, ids, start = _k8_inputs(gen, rng, shape, dtype, device)
            errs = []
            for softcap in (0.0, 50.0):
                for empty_mean in (True, False):
                    kw = dict(block_size=bs, softcap=softcap,
                              empty_mean=empty_mean)
                    errs.append(_hold(
                        f"K8 {shape[0]} softcap={softcap} "
                        f"empty_mean={empty_mean}",
                        K8.block_sparse_attention(q, k, v, ids, start, **kw),
                        K8.block_sparse_attention_plain(q, k, v, ids, start,
                                                        **kw), dtype))
            worst = max(worst, *errs)
            _log("kernels", kernel="block_sparse_attention", shape=shape[0],
                 H=shape[3], KVH=shape[4], dqk=shape[5], dv=shape[6],
                 block_size=bs, nb=shape[8], S=shape[2], T=shape[9],
                 dtype=str(dtype).split(".")[1], max_abs_err=max(errs))
    for shape in (K8_SHAPES[2], ("yi6b_short",) + K8_SHAPES[0][1:9] + (2048,),
                  ("glm5_mla_short",) + K8_SHAPES[1][1:9] + (2048,)):
        q, k, v, ids, start = _k8_inputs(gen, rng, shape, torch.float32,
                                         device)
        pos = start[:, None] + torch.arange(shape[2], device=device)
        _same_grads(f"sparse_block_attention {shape[0]}",
                    lambda a, b, c: dsa_mod.sparse_block_attention(
                        a, b, c, torch.where(ids >= 0, ids, -ids - 1),
                        ids >= 0, pos, shape[7],
                        softcap=50.0), (q, k, v))
    _log("kernels", autograd="sparse_block_attention",
         grads="equal on both routes")
    return {"block_sparse_attention": worst}


def time_sparse_kernels(cfg, span_end, view_len, train_seq, device="cuda",
                        reps=20) -> dict:
    """K8 at the serve phase's shape, a 256-query span ending at
    ``span_end`` over a gathered view of ``view_len`` keys (Yi-6B + DSA(block),
    bf16), and at the training run's, the last 256-query chunk against
    ``train_seq`` keys (fp32; both fp32 lines run the 3xTF32 tile); the
    top_k // 128 blocks of each query block all lie before it, so every
    query attends all nb * 128 of its keys.  Beside each: the device time
    of the same calls from a CUDA graph, the plain version, and
    scaled_dot_product_attention over each query block's selected K/V
    gathered (and the KV heads repeated) once before the timed loop, with a
    boolean causal mask (timed here only), and the key-range parts the
    wrapper picks.  Bound: flops 4*S*H*nb*bs*d over the bf16 peak (fp32:
    three times that over the TF32 peak, the CUDA cores' bound logged
    beside), or the bytes of q, out, the ids and the distinct selected
    blocks' K/V over 3.35 TB/s, the larger."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.build import DTYPE_CODE
    from repro_torch.kernels.sparse_attention import kernel as K8
    rng = np.random.default_rng(SEED + 5)
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    H, KVH, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G, bs = H // KVH, cfg.dsa.block_size
    nb, S = cfg.dsa.top_k // bs, 256
    out = {}
    for name, end, T, dtype in (
            ("block_sparse_attention", span_end, view_len, torch.bfloat16),
            ("block_sparse_attention_fp32", span_end, view_len,
             torch.float32),
            ("block_sparse_attention_train", train_seq, train_seq,
             torch.float32)):
        start = end - S
        q = torch.randn((1, S, H, d), generator=gen, device=device).to(dtype)
        k = torch.randn((1, T, KVH, d), generator=gen, device=device) \
            .to(dtype)
        v = torch.randn((1, T, KVH, d), generator=gen, device=device) \
            .to(dtype)
        before = start // bs                     # blocks wholly before
        sel = np.stack([rng.permutation(before)[:nb]
                        for _ in range(S // bs)])
        ids = torch.from_numpy(sel[None].astype(np.int32)).to(device)
        qs = torch.tensor([start], dtype=torch.int32, device=device)
        kw = dict(block_size=bs, empty_mean=True)
        ms = cuda_ms(lambda: K8.block_sparse_attention(q, k, v, ids, qs,
                                                       **kw), reps)
        device_ms = graph_ms(lambda: K8.block_sparse_attention(
            q, k, v, ids, qs, **kw), reps)
        plain_ms = cuda_ms(lambda: K8.block_sparse_attention_plain(
            q, k, v, ids, qs, **kw), 3)
        tok = (ids.long()[..., None] * bs
               + torch.arange(bs, device=device)).reshape(S // bs, nb * bs)
        kg = k[0][tok].permute(0, 2, 1, 3).repeat_interleave(G, 1) \
            .contiguous()                         # (nqb, H, nb*bs, d)
        vg = v[0][tok].permute(0, 2, 1, 3).repeat_interleave(G, 1) \
            .contiguous()
        qb = q[0].reshape(S // bs, bs, H, d).transpose(1, 2).contiguous()
        qpos = start + torch.arange(S, device=device).reshape(S // bs, bs)
        mask = (tok[:, None, :] <= qpos[..., None])[:, None]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qb, kg, vg, attn_mask=mask), reps)
        err = _hold(f"K8 {name}", K8.block_sparse_attention(q, k, v, ids, qs,
                                                            **kw),
                    K8.block_sparse_attention_plain(q, k, v, ids, qs, **kw),
                    dtype)
        item = q.element_size()
        blocks = int(torch.unique(ids).numel())
        nbytes = 2 * q.numel() * item + ids.numel() * 4 \
            + blocks * bs * KVH * d * 2 * item
        flops = 4 * S * H * nb * bs * d
        dn = str(dtype).split(".")[1]
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        extra = {}
        if dn == "bfloat16":
            t_ops = flops / H100_FLOPS[dn] * 1e3
        else:   # three TF32 products; the CUDA cores' fp32 bound beside
            t_ops = 3 * flops / H100_FLOPS["tf32"] * 1e3
            extra = dict(tf32_products=3, bound_ms_fp32_cores=max(
                t_bytes, flops / H100_FLOPS["float32"] * 1e3))
        r = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                 library_ms=lib_ms, max_abs_err=err, bytes=nbytes,
                 flops=flops,
                 bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 shape=f"S={S} start={start} T={T} H={H} KVH={KVH} d={d} "
                       f"bs={bs} nb={nb}")
        out[name] = r
        _log("timing", kernel=name, shape=repr(r["shape"]), ms=ms,
             device_ms=device_ms, plain_ms=plain_ms, library_ms=lib_ms,
             bound_ms=r["bound_ms"], bound_by=r["bound_by"], **extra,
             max_abs_err=err, dtype=dn,
             body="mma_tile (tensor cores)" if dn == "bfloat16"
             else "tf32_tile (3xTF32, tensor cores)",
             parts=build.key_split(
                 "block_sparse_resources", (DTYPE_CODE[dtype], d, d),
                 bs * G, S // bs * KVH, d, q.device)[0],
             tflops=flops / device_ms / 1e9,
             bound_share=r["bound_ms"] / device_ms)
        del q, k, v, kg, vg, qb
    return out


def time_k7_span(cfg, span_end, view_len, device="cuda", reps=32) -> dict:
    """K7 as the block selector's serve runs it (bf16, its tensor-core
    body): the last 256-query span of a prompt ending at ``span_end``
    scored against the gathered view of ``view_len`` index keys (the shape
    logged), each call on another of 8 layers' keys (so they come from
    device memory): the wrapper's time, its device time from CUDA-graph
    replay, its host microseconds a call and the plain version's, held at
    the bf16 bound.  Bound: flops S*T*Hi*(2*Di + 2) over the bf16 peak or
    the bytes of q, w, the keys and the fp32 scores over 3.35 TB/s."""
    import torch
    from repro_torch.kernels.lightning_indexer import kernel as K7
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    Hi, Di, S, layers = cfg.dsa.index_heads, cfg.dsa.index_head_dim, 256, 8
    T = view_len
    q = torch.randn((1, S, Hi * Di), generator=gen,
                    device=device).bfloat16()
    w = torch.softmax(torch.randn((1, S, Hi), generator=gen, device=device),
                      -1)
    ks = [torch.randn((1, T, Di), generator=gen, device=device).bfloat16()
          for _ in range(layers)]
    it = iter(range(10 ** 9))
    kw = dict(heads=Hi, head_dim=Di)

    def call():
        return K7.lightning_indexer(q, w, ks[next(it) % layers], **kw)
    err = _hold("K7 serve-span", K7.lightning_indexer(q, w, ks[0], **kw),
                K7.reference(q, w, ks[0], **kw), torch.bfloat16)
    err32 = _hold("K7 serve-span",
                  K7.lightning_indexer(q.float(), w, ks[0].float(), **kw),
                  K7.reference(q.float(), w, ks[0].float(), **kw),
                  torch.float32)
    shape = f"S={S} start={span_end - S} T={T} Hi={Hi} Di={Di}"
    _log("timing", kernel="lightning_indexer", serve_span_shape=repr(shape))
    out = {"lightning_indexer_serve": dict(
        ms=cuda_ms(call, reps), device_ms=graph_ms(call, reps),
        plain_ms=cuda_ms(lambda: K7.reference(q, w, ks[next(it) % layers],
                                              **kw), 4),
        library_ms=None, max_abs_err=err, max_abs_err_fp32=err32,
        flops=S * T * Hi * (2 * Di + 2),
        bytes=2 * (q.numel() + T * Di) + 4 * (w.numel() + S * T),
        extra=dict(host_us=host_us(call, 100),
                   body="indexer_mma (tensor cores)"),
        shape=shape)}
    _bounds(out)
    return out


# ---------------------------------------------------------------------------
# engine parity in fp32 (full width, 2 layers)
# ---------------------------------------------------------------------------

def _margins_ok(model, prompt, out, device, min_margin=1e-3) -> bool:
    """Top-2 logit margin of every generated position under teacher forcing
    (the full-sequence forward without a cache)."""
    import numpy as np
    import torch
    from repro_torch.models import get_model
    seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
    with torch.no_grad():
        lg = get_model(model.cfg).logits(
            model, torch.from_numpy(seq)[None].to(device))[0]
    lg = lg[len(prompt) - 1:].float()
    top2 = lg.topk(2, dim=-1).values
    return bool(((top2[:, 0] - top2[:, 1]) >= min_margin).all())


def _short_prompts(rng, V, block_size):
    """Mixed short prompts: a shared prefix ending mid-block (radix hit and
    COW fork), an exact duplicate, an unrelated prompt."""
    import numpy as np
    sys_p = rng.integers(3, V, size=block_size * 2 + 5)
    prompts = [np.concatenate([sys_p, rng.integers(3, V, size=n)])
               for n in (7, 30, 3, 61)]
    prompts.append(prompts[1].copy())                     # exact duplicate
    prompts.append(rng.integers(3, V, size=90))
    return [p.astype(np.int32) for p in prompts], [6, 9, 4, 8, 5, 7]


def _long_prompts(rng, V, shared=200, lens=(2600, 3000)):
    """DSA parity prompts: two short ones and then two of ``lens`` tokens
    (2600 and 3000), all four on a 200-token system prompt that ends
    mid-block (served two at a time, each long prompt is admitted when a
    short one has finished and left the prefix in the radix cache: a hit
    and a COW fork), so top-2048 really discards keys; then two unrelated
    short prompts."""
    import numpy as np
    sys_p = rng.integers(3, V, size=shared)
    prompts = [np.concatenate([sys_p, rng.integers(3, V, size=n)])
               for n in (7, 30)]
    prompts += [np.concatenate([sys_p, rng.integers(3, V, size=n - shared)])
                for n in lens]
    prompts += [rng.integers(3, V, size=n) for n in (3, 90)]
    return [p.astype(np.int32) for p in prompts], [6, 9, 8, 5, 4, 7]


def _all_launched(kernels, before) -> bool:
    return all(k.launches > n for k, n in zip(kernels, before))


def _teacher_logprobs(model, prompt, out, device):
    """The logprobs of ``out`` after ``prompt`` under teacher forcing (the
    full-sequence forward without a cache, temperature 1)."""
    import numpy as np
    import torch
    from repro_torch.models import get_model
    seq = np.concatenate([prompt, out[:-1]]).astype(np.int64)
    with torch.no_grad():
        lg = get_model(model.cfg).logits(
            model, torch.from_numpy(seq)[None].to(device))[0]
    lp = torch.log_softmax(lg[len(prompt) - 1:].float(), dim=-1)
    idx = torch.from_numpy(out.astype(np.int64)).to(device)[:, None]
    return lp.gather(1, idx)[:, 0].cpu().numpy()


def parity(cfg, device="cuda", block_size=16, chunks=(64,),
           long=False, long_lens=(2600, 3000), logprobs=False) -> list:
    """fp32 greedy tokens of the port's ContinuousEngine against its
    ServingEngine oracle, on the short prompt mix or (``long``) the DSA mix
    with prompts past top-k (two of ``long_lens`` tokens; gemma2's pass
    its 4096 window), once for each prefill chunk of ``chunks``
    (None: whole-prompt prefill) against one oracle run.  The oracle and
    the margin check run on the plain route: their contiguous DSA scores
    would otherwise reach K7, whose tile body K5/K6 share, so the engine's
    kernels are held against plain indexer scores, and the hybrid's
    Mamba-2 scans against K11's plain head-shared form.  The hybrid
    serves without the prefix cache (its recurrent state cannot be
    re-aliased): there the workload must reuse slots (more requests than
    slots) instead of hitting the radix tree.  With ``logprobs`` the
    engine also records the temperature-1 logprob of every token it emits
    (``true_logprobs``), each held within 1e-4 x max(1, |lp|) of the plain
    route's teacher-forced logprob of the same token: gemma2's final
    softcap (30) saturates on random weights at its width (its trainer's
    first loss is ~40 against ln 256000 = 12.45 on an H100), so no prompt
    had a top-2 margin of 1e-3 there and the token rule compares none; the
    logprobs hold every position of the served path to the plain one all
    the same.
    Returns each chunk's result."""
    import numpy as np
    import torch
    from repro_torch.models import get_model
    from repro_torch.serving import ContinuousEngine, Request, ServingEngine
    model = get_model(cfg).init(
        cfg, torch.Generator(device=device).manual_seed(SEED), device=device,
        dtype=torch.float32)
    rng = np.random.default_rng(SEED + 1)
    if long:
        prompts, max_new = _long_prompts(rng, cfg.vocab_size, lens=long_lens)
    else:
        prompts, max_new = _short_prompts(rng, cfg.vocab_size, block_size)
    max_len = max(len(p) for p in prompts) + max(max_new) \
        + max(c or 0 for c in chunks)
    max_len = -(-max_len // block_size) * block_size
    oracle = ServingEngine(cfg, model, max_batch=1, max_len=max_len,
                           device=device)
    oreqs = [Request(prompt=p, max_new=m) for p, m in zip(prompts, max_new)]
    with plain_route():
        oracle.serve(oreqs)
        margins = [_margins_ok(model, p, o.out, device)
                   for p, o in zip(prompts, oreqs)]
    if not any(margins) and not logprobs:
        raise AssertionError("parity: no prompt had a top-2 margin")
    kernels = [k for ks in path_kernels(cfg) for k in ks]
    hybrid = cfg.family == "hybrid"
    results = []
    for chunk in chunks:
        before = [k.launches for k in kernels]
        eng = ContinuousEngine(cfg, model, max_batch=2 if long else 3,
                               block_size=block_size,
                               num_blocks=512 if long else 128,
                               max_len=max_len, prefill_chunk=chunk,
                               capture_logprobs=logprobs,
                               true_logprobs=logprobs, device=device)
        reqs = [Request(prompt=p, max_new=m)
                for p, m in zip(prompts, max_new)]
        eng.serve(reqs)
        for r, o, ok in zip(reqs, oreqs, margins):
            if ok and not np.array_equal(r.out, o.out):
                raise AssertionError(f"parity: engine {r.out.tolist()} != "
                                     f"oracle {o.out.tolist()}")
        lp_err = None
        if logprobs:
            with plain_route():
                want = [_teacher_logprobs(model, p, r.out, device)
                        for p, r in zip(prompts, reqs)]
            rel = [np.abs(r.out_logprobs - w) / np.maximum(1.0, np.abs(w))
                   for r, w in zip(reqs, want)]
            lp_err = max(float(x.max()) for x in rel)
            if not lp_err <= TOL["float32"]:
                raise AssertionError(f"parity: the engine's logprobs are "
                                     f"{lp_err} (relative) from the plain "
                                     f"route's")
        st = eng.stats
        if (eng.prefix is None) != hybrid or not hybrid and (
                st["cached_tokens"] <= 0 or st["cow_forks"] <= 0) \
                or not any(s > 0 for s in st["admit_steps"]):
            raise AssertionError(f"parity: workload missed radix/COW/"
                                 f"mid-flight admission: {dict(st)}")
        if device != "cpu" and not _all_launched(kernels, before):
            raise AssertionError(f"parity: one of "
                                 f"{[k.__name__ for k in kernels]} never "
                                 f"launched")
        res = dict(compared=sum(margins), skipped=len(margins) - sum(margins),
                   longest_prompt=max(len(p) for p in prompts),
                   cached_tokens=st["cached_tokens"],
                   cow_forks=st["cow_forks"], chunk_steps=st["chunk_steps"],
                   max_rel_logprob_err=lp_err)
        _log("parity", model=cfg.name, layers=cfg.num_layers,
             d_model=cfg.d_model, experts=cfg.num_experts,
             dsa=cfg.dsa is not None, prefill_chunk=chunk, dtype="float32",
             **res)
        results.append(res)
        del eng
    del oracle, model
    return results


def _hold_logits(what, got, want) -> float:
    """fp32 logits of the kernel route within 1e-4 of the plain route's,
    relative to max(1, max |plain|) (the logits' own scale, not the
    kernels' unit scale); returns the max abs error."""
    import torch
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL["float32"] * max(1.0, want.float().abs().max().item())
    if not torch.isfinite(got).all() or err > tol:
        raise AssertionError(f"{what}: max abs err {err} > {tol} or "
                             f"non-finite")
    return err


def parity_prefill_step(cfg, device="cuda", batch=2, text=64) -> dict:
    """A VLM's ``launch.steps.make_prefill_step`` in fp32 over ``batch``
    rows of ``frontend_tokens`` patch embeddings and ``text`` tokens: the
    last position's logits on the kernel route (K9, one launch a layer)
    against the plain route's."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import kernel as K9
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import get_model
    model = get_model(cfg).init(
        cfg, torch.Generator(device=device).manual_seed(SEED), device=device)
    rng = np.random.default_rng(SEED + 5)
    b = {"tokens": torch.from_numpy(rng.integers(
        3, cfg.vocab_size, (batch, text)).astype(np.int32)).to(device),
         "frontend_embeds": frontend_embeds(cfg, batch, device)}
    step = make_prefill_step(model)
    before = K9.flash_attention.launches
    got = step(b)
    launched = K9.flash_attention.launches - before
    with plain_route():
        want = step(b)
    if device != "cpu" and launched != cfg.num_layers:
        raise AssertionError(f"prefill step {cfg.name}: K9 launched "
                             f"{launched} times, not once a layer")
    err = _hold_logits(f"prefill step {cfg.name}", got, want)
    _log("parity", model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         family=cfg.family, path="make_prefill_step", batch=batch,
         frontend_rows=frontend_rows(cfg), text=text, dtype="float32",
         k9_launches=launched, logits_max_abs_err=err)
    del model
    return dict(logits_max_abs_err=err)


def _encdec_greedy(model, frames, prompt, new, device):
    """Greedy decoding through the encoder-decoder's prefill and ``new``
    decode steps over a contiguous cache: (the steps' logits (B, new + 1,
    V), the tokens chosen (B, new + 1))."""
    import torch
    from repro_torch.models import encdec
    B, S = prompt.shape
    cache = encdec.init_cache(model.cfg, B, S + new + 1,
                              dtype=next(model.parameters()).dtype,
                              device=device)
    lg, cache = encdec.prefill(model, prompt, cache, frontend_embeds=frames)
    logits, toks = [lg], [lg.argmax(-1)]
    for i in range(new):
        lg, cache = encdec.decode_step(model, toks[-1], cache, S + i)
        logits.append(lg)
        toks.append(lg.argmax(-1))
    return torch.cat(logits, 1), torch.cat(toks, 1)


def parity_encdec(cfg, device="cuda", batch=4, prompt_len=32,
                  new=16) -> dict:
    """The encoder-decoder whole, fp32, on ``batch`` rows of frames and a
    ``prompt_len``-token prompt: prefill + ``new`` greedy decode steps on
    the kernel route equal to the full forward over the tokens they chose
    (each step's logits within ``_hold_logits``' bound of the forward's),
    and the greedy tokens equal to the plain route's wherever the plain
    route's top-2 margin is >= 1e-3 at every step (rows without one are
    skipped)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import kernel as K9
    from repro_torch.models import encdec
    model = encdec.init(cfg, torch.Generator(device=device).manual_seed(SEED),
                        device=device)
    rng = np.random.default_rng(SEED + 6)
    prompt = torch.from_numpy(rng.integers(
        3, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)).to(device)
    frames = frontend_embeds(cfg, batch, device)
    before = K9.flash_attention.launches
    lg_k, tok_k = _encdec_greedy(model, frames, prompt, new, device)
    launched = K9.flash_attention.launches - before
    want = cfg.encoder_layers + cfg.num_layers * (new + 1)
    if device != "cpu" and launched != want:
        raise AssertionError(f"parity {cfg.name}: K9 launched {launched} "
                             f"times, the steps imply {want}")
    with torch.no_grad():
        full = encdec.logits(model, torch.cat([prompt, tok_k[:, :-1]], 1),
                             frontend_embeds=frames)[:, prompt_len - 1:]
    err = _hold_logits(f"{cfg.name} decode = forward", lg_k, full)
    with plain_route():
        lg_p, tok_p = _encdec_greedy(model, frames, prompt, new, device)
    top2 = lg_p.float().topk(2, dim=-1).values
    ok = ((top2[..., 0] - top2[..., 1]) >= 1e-3).all(-1)
    for b in range(batch):
        if ok[b] and not torch.equal(tok_k[b], tok_p[b]):
            raise AssertionError(f"parity {cfg.name}: row {b} tokens "
                                 f"{tok_k[b].tolist()} != plain "
                                 f"{tok_p[b].tolist()}")
    if not ok.any():
        raise AssertionError(f"parity {cfg.name}: no row had a top-2 margin")
    res = dict(compared=int(ok.sum()), skipped=int((~ok).sum()),
               decode_eq_forward_max_abs_err=err, k9_launches=launched)
    _log("parity", model=cfg.name, layers=cfg.num_layers,
         encoder_layers=cfg.encoder_layers, d_model=cfg.d_model,
         family=cfg.family, frames=cfg.encoder_seq_len, batch=batch,
         prompt=prompt_len, new_tokens=new, dtype="float32", **res)
    del model
    return res


def _round_up(n, m):
    return -(-n // m) * m


def _k8_expected(eng, model) -> tuple:
    """(spans, spans that reach K8, K8 launches they imply) from the
    engine's trace: K8 runs in every DSA layer of a span whose length is a
    whole number of DSA blocks (the view is one: ``max_len`` rounded)."""
    spans = [e["args"]["span"] for e in eng.tracer.export()["traceEvents"]
             if e["name"] == "req.prefill"]
    whole = sum(1 for n in spans if n % model.cfg.dsa.block_size == 0)
    return len(spans), whole, whole * sum(1 for b in model.layers
                                          if hasattr(b, "idx"))


def parity_block(cfg, device="cuda", block_size=16, chunk=256) -> dict:
    """fp32 greedy tokens of the engine with the DSA block selector on the
    kernel route against the same engine, same scheduling, on the plain
    route (``attn_impl="ref"`` and the plain versions of K7/K8): the long
    DSA mix (prompts of 2600 and 3000 tokens, so selection discards keys),
    spans of 256 (K8 in every layer of every whole span).  The static
    oracle cannot serve here: the block selector pools query blocks that
    start at a span's start, and a query block that sees no key takes the
    mean of its listed blocks' V, which past the sequence is whatever the
    view holds (ROADMAP queue 3), so the result depends on the span
    boundaries and the pool as the engine schedules them."""
    import numpy as np
    import torch
    from repro_torch.kernels.sparse_attention import kernel as K8
    from repro_torch.models import transformer as T
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving import ContinuousEngine, Request
    model = T.init(cfg, torch.Generator(device=device).manual_seed(SEED),
                   device=device, dtype=torch.float32)
    rng = np.random.default_rng(SEED + 1)
    prompts, max_new = _long_prompts(rng, cfg.vocab_size)
    max_len = _round_up(max(len(p) for p in prompts) + max(max_new) + chunk,
                        cfg.dsa.block_size)
    outs, launches = {}, {}
    for route in ("kernel", "plain"):
        K8.block_sparse_attention.launches = 0
        eng = ContinuousEngine(cfg, model, max_batch=2,
                               block_size=block_size, num_blocks=512,
                               max_len=max_len, prefill_chunk=chunk,
                               attn_impl="kernel" if route == "kernel"
                               else "ref", tracer=Tracer(enabled=True),
                               device=device)
        reqs = [Request(prompt=p, max_new=m)
                for p, m in zip(prompts, max_new)]
        if route == "kernel":
            eng.serve(reqs)
        else:
            with plain_route():
                eng.serve(reqs)
        outs[route] = [r.out for r in reqs]
        launches[route] = K8.block_sparse_attention.launches
        st = eng.stats
        n_spans, k8_spans, want = _k8_expected(eng, model)
    for a, b in zip(outs["kernel"], outs["plain"]):
        if not np.array_equal(a, b):
            raise AssertionError(f"parity (block selector): kernel route "
                                 f"{a.tolist()} != plain {b.tolist()}")
    if device != "cpu" and (launches["kernel"] != want or want <= 0
                            or launches["plain"] != 0):
        raise AssertionError(f"parity (block selector): K8 launches "
                             f"{launches}, the spans imply {want}")
    if st["cached_tokens"] <= 0 or st["cow_forks"] <= 0:
        raise AssertionError(f"parity (block selector): no radix hit / COW "
                             f"fork: {dict(st)}")
    res = dict(compared=len(prompts), longest_prompt=max(map(len, prompts)),
               max_len=max_len, spans=n_spans, k8_spans=k8_spans,
               k8_launches=launches["kernel"],
               cached_tokens=st["cached_tokens"], cow_forks=st["cow_forks"])
    _log("parity", model=cfg.name, layers=cfg.num_layers,
         selector="block", dtype="float32", oracle="plain route", **res)
    del model
    return res


def parity_mtp(cfg, device="cuda", block_size=16, chunk=64, n=3) -> dict:
    """fp32 greedy tokens with MTP speculation (``spec_steps=n``) against
    ``spec_steps=0`` on the short mix, wherever the top-2 margin is >= 1e-3;
    then a forced-acceptance run: the script points
    ``speculative.mtp_draft`` at the spec-off run's own continuation, so
    every draft accepts, the rounds emit n + 1 tokens (fewer only at a
    request's budget cap), and the tokens must still be equal.  Every run
    captures true logprobs: the spec runs' (bonus tokens and, in the
    forced run, accepted drafts, from the verify span's logits) within the
    fp32 tolerance 1e-4, relative where |lp| > 1, of the spec-off run's
    (the decode steps') wherever the tokens are compared."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving import ContinuousEngine, Request
    from repro_torch.serving import speculative
    model = T.init(cfg, torch.Generator(device=device).manual_seed(SEED),
                   device=device, dtype=torch.float32)
    rng = np.random.default_rng(SEED + 1)
    prompts, max_new = _short_prompts(rng, cfg.vocab_size, block_size)
    max_len = _round_up(max(len(p) for p in prompts) + max(max_new) + chunk,
                        block_size)

    def run(spec, draft=None):
        eng = ContinuousEngine(cfg, model, max_batch=3, block_size=block_size,
                               num_blocks=128, max_len=max_len,
                               prefill_chunk=chunk, spec_steps=spec,
                               capture_logprobs=True, true_logprobs=True,
                               device=device)
        reqs = [Request(prompt=p, max_new=m)
                for p, m in zip(prompts, max_new)]
        saved = speculative.mtp_draft
        if draft is not None:     # request -> its spec-off tokens
            want = {id(r): o for r, o in zip(reqs, base)}
            speculative.mtp_draft = lambda *a: draft(eng, want, *a)
        try:
            eng.serve(reqs)
        finally:
            speculative.mtp_draft = saved
        return [r.out for r in reqs], eng, [r.out_logprobs for r in reqs]

    base, _, base_lp = run(0)
    spec_out, spec_eng, spec_lp = run(n)

    def forced(eng, want, model_, h, tok, pos, depth):
        drafts = torch.zeros((tok.shape[0], depth), dtype=torch.long,
                             device=tok.device)
        for i, s in enumerate(eng.slots):
            if s is not None and s.pending is not None:
                nxt = want[id(s.req)][len(s.out) + 1:len(s.out) + 1 + depth]
                drafts[i, :len(nxt)] = torch.from_numpy(nxt.astype(np.int64))
        return drafts

    forced_out, forced_eng, forced_lp = run(n, forced)
    with plain_route():
        margins = [_margins_ok(model, p, o, device)
                   for p, o in zip(prompts, base)]

    def lp_gap(want, got):          # relative where |lp| > 1
        return float((np.abs(got - want)
                      / np.maximum(1.0, np.abs(want))).max())
    compared, lp_worst = 0, 0.0
    for ok, a, b, c, la, lb, lc in zip(margins, base, spec_out, forced_out,
                                       base_lp, spec_lp, forced_lp):
        if not np.array_equal(a, c):
            raise AssertionError(f"parity (MTP forced): {c.tolist()} != "
                                 f"{a.tolist()}")
        lp_worst = max(lp_worst, lp_gap(la, lc))
        if ok:
            compared += 1
            if not np.array_equal(a, b):
                raise AssertionError(f"parity (MTP): spec {b.tolist()} != "
                                     f"{a.tolist()}")
            lp_worst = max(lp_worst, lp_gap(la, lb))
    if lp_worst > TOL["float32"]:
        raise AssertionError(f"parity (MTP): true logprobs of the spec "
                             f"runs {lp_worst} from spec off's")
    fs = forced_eng.stats
    if compared == 0 or fs["accepted_tokens"] != \
            fs["draft_tokens"] + fs["spec_rounds"] \
            or fs["draft_tokens"] <= fs["spec_rounds"]:
        raise AssertionError(f"parity (MTP): compared {compared}, forced "
                             f"stats {dict(fs)}")
    ss = spec_eng.stats
    res = dict(compared=compared, skipped=len(prompts) - compared,
               spec_rounds=ss["spec_rounds"],
               accept_length=spec_eng.rolling_accept_length,
               forced_rounds=fs["spec_rounds"],
               forced_accept_length=forced_eng.rolling_accept_length,
               forced_accepted=fs["accepted_tokens"],
               forced_drafted=fs["draft_tokens"],
               true_logprob_gap_rel=lp_worst)
    _log("parity", model=cfg.name, layers=cfg.num_layers,
         experts=cfg.num_experts, mtp=n, dtype="float32",
         oracle="spec_steps=0", **res)
    del model
    return res


# ---------------------------------------------------------------------------
# serve at full width and depth in bf16
# ---------------------------------------------------------------------------

def serve_launches(cfg, st) -> dict:
    """The paged kernels' launches that a GQA transformer's serve run
    implies without speculation, from the engine's ``stats``: a decode step
    launches K1 once a layer without DSA (gemma2's local layers; every
    layer without a DSA config) and K5 once a DSA layer (the global ones);
    each prefill span (the scheduler's ``chunk_steps``: one slot's span)
    K2 and K6 likewise."""
    from repro_torch.models.transformer import layer_kind
    L = cfg.num_layers
    dsa = sum(layer_kind(cfg, i) == "global" for i in range(L)) \
        if cfg.dsa is not None else 0
    out = {"paged_decode_gqa": (L - dsa) * st["decode_steps"],
           "paged_prefill_gqa": (L - dsa) * st["chunk_steps"]}
    if dsa:
        out.update(paged_indexer_scores_kernel=dsa * st["decode_steps"],
                   paged_prefill_indexer=dsa * st["chunk_steps"])
    return out


def _mix_prompts(V, prompt_lens, shared):
    """The serve mix: (system prompt, prompts), the prompts at even places
    that are longer than the system prompt starting with it."""
    import numpy as np
    rng = np.random.default_rng(SEED + 2)
    sys_p = rng.integers(3, V, size=shared)
    prompts = []
    for i, n in enumerate(prompt_lens):
        if i % 2 == 0 and n > shared:     # half share the system prefix
            p = np.concatenate([sys_p, rng.integers(3, V, size=n - shared)])
        else:
            p = rng.integers(3, V, size=n)
        prompts.append(p.astype(np.int32))
    return sys_p.astype(np.int32), prompts


def serve(cfg, prompt_lens, device="cuda", block_size=16, num_blocks=2048,
          chunk=256, max_new=32, shared=200, spec_steps=0,
          model=None) -> dict:
    """The engine at full width in bf16 on a request mix (half of the
    prompts on a shared system prompt), after a warm-up: decode tok/s,
    TTFT / TPOT p50, the path's kernel launches (and, with the DSA block
    selector, K8's against the spans that reach it: every layer of every
    span a whole number of DSA blocks long; with speculation the accept
    length and the rounds).  ``model`` (bf16) may be handed in to serve
    it again; the result carries it under ``"model"``."""
    import numpy as np
    import torch
    from repro_torch.models import get_model
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving import ContinuousEngine, Request
    t0 = time.perf_counter()
    if model is None:
        model = get_model(cfg).init(
            cfg, torch.Generator(device=device).manual_seed(SEED),
            device=device, dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    block_sel = cfg.dsa is not None and cfg.dsa.selector == "block" \
        and cfg.attention_type != "mla"
    max_len = max(prompt_lens) + max_new + chunk
    if block_sel:     # the gathered view: a whole number of DSA blocks
        max_len = _round_up(max_len, cfg.dsa.block_size)
    eng = ContinuousEngine(cfg, model, max_batch=8, block_size=block_size,
                           num_blocks=num_blocks, max_len=max_len,
                           prefill_chunk=chunk, spec_steps=spec_steps,
                           tracer=Tracer(enabled=block_sel), device=device)
    pool_gib = sum(x.numel() * x.element_size() for lv in eng.pool.values()
                   for x in lv.values()) / 2 ** 30
    V = cfg.vocab_size
    sys_p, prompts = _mix_prompts(V, prompt_lens, shared)
    # warm-up, not measured: the system prompt alone, as earlier traffic
    # would have left it in the radix cache (also warms cuBLAS/allocator)
    eng.serve([Request(prompt=sys_p.astype(np.int32), max_new=4)])
    setup_s = time.perf_counter() - t0
    eng.stats = {}
    eng.registry.reset_histograms("engine")
    eng.tracer.clear()
    reqs = [Request(prompt=p, max_new=max_new) for p in prompts]
    k_dec, k_pre = path_kernels(cfg, spec_steps)
    for k in k_dec + k_pre:
        k.launches = 0                         # counts of the main path
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    decode_s, decode_toks = 0.0, 0
    while eng.busy:
        before = (eng.stats["prefills"], eng.stats["chunk_steps"],
                  eng.stats["decode_tokens"])
        ts = time.perf_counter()
        eng.step()                 # ends with logits on the host: synced
        dt = time.perf_counter() - ts
        if (eng.stats["prefills"], eng.stats["chunk_steps"]) == before[:2]:
            decode_s += dt         # a step with no prefill work
            decode_toks += eng.stats["decode_tokens"] - before[2]
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in k_dec + k_pre}
    for r in reqs:
        if r.status != "ok" or r.out is None or len(r.out) != max_new:
            raise AssertionError(f"serve: request {r.rid} ended "
                                 f"{r.status} ({r.error!r})")
        if not ((r.out >= 0) & (r.out < V)).all():
            raise AssertionError(f"serve: token out of range in {r.rid}")
    for lv in eng.pool.values():
        for x in lv.values():
            if not torch.isfinite(x).all():
                raise AssertionError("serve: non-finite value in the pool")
    if device != "cpu" and 0 in launches.values():
        raise AssertionError(f"serve: a kernel never launched: {launches}")
    st = eng.stats
    extra = {}
    if block_sel:
        n_spans, whole, want = _k8_expected(eng, model)
        got = launches["block_sparse_attention"]
        if got != want:
            raise AssertionError(f"serve: K8 launched {got} times, the "
                                 f"spans imply {want}")
        extra = dict(spans=n_spans, k8_spans=whole,
                     k8_launches_per_k8_span=got / max(whole, 1))
    if "local" in cfg.attention_pattern and not spec_steps:
        want = serve_launches(cfg, st)
        if device != "cpu" and launches != want:
            raise AssertionError(f"serve: launches {launches} != expected "
                                 f"{want}")
    if cfg.family == "hybrid":    # K11 in every layer of every step and span
        got = launches["mamba_scan_heads"]
        want = cfg.num_layers * (st["decode_steps"] + st["chunk_steps"])
        if device != "cpu" and got != want:
            raise AssertionError(f"serve: K11 (head-shared) launched {got} "
                                 f"times, the steps and spans imply {want}")
        extra = dict(ssm_state_mib=sum(
            x.numel() * x.element_size() for x in eng.pool["ssm"].values())
            / 2 ** 20)
    if spec_steps:
        extra.update(spec_steps=spec_steps, spec_rounds=st["spec_rounds"],
                     accept_length=eng.rolling_accept_length,
                     draft_tokens=st["draft_tokens"],
                     accepted_tokens=st["accepted_tokens"])
    lat = eng.latency_summary()
    res = dict(
        params_b=n_params / 1e9, pool_gib=pool_gib, requests=len(reqs),
        prompt_tokens=int(sum(prompt_lens)),
        cached_tokens=st["cached_tokens"],
        decode_tokens=st["decode_tokens"], decode_steps=st["decode_steps"],
        chunk_steps=st["chunk_steps"], wall_s=wall, setup_s=setup_s,
        decode_tok_s=decode_toks / decode_s if decode_s else 0.0,
        decode_only_steps_s=decode_s,
        ttft_p50_ms=lat["ttft_ms"]["p50"], tpot_p50_ms=lat["tpot_ms"]["p50"],
        **extra)
    for k in k_dec:
        res[f"{k.__name__}_launches"] = k.launches
        res[f"{k.__name__}_per_decode_step"] = \
            k.launches / max(st["decode_steps"], 1)
    for k in k_pre:
        res[f"{k.__name__}_launches"] = k.launches
        res[f"{k.__name__}_per_prefill_span"] = \
            k.launches / max(st["chunk_steps"], 1)
    _log("serve", model=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, family=cfg.family, experts=cfg.num_experts,
         dsa=cfg.dsa is not None,
         selector=cfg.dsa.selector if cfg.dsa is not None else None,
         mtp=cfg.mtp is not None, dtype="bfloat16", **res)
    res["launches"] = launches
    res["model"] = model
    del eng
    return res


def serve_prefill_step(cfg, model, device="cuda", batch=1,
                       text=1472) -> dict:
    """A VLM's ``launch.steps.make_prefill_step`` on the served bf16 model:
    ``batch`` rows of ``frontend_tokens`` patches and ``text`` tokens, the
    last position's logits finite; its ms (CUDA events, after a warm-up)
    and K9's launches (bf16, one a layer)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import kernel as K9
    from repro_torch.launch.steps import make_prefill_step
    rng = np.random.default_rng(SEED + 7)
    b = {"tokens": torch.from_numpy(rng.integers(
        3, cfg.vocab_size, (batch, text)).astype(np.int32)).to(device),
         "frontend_embeds": frontend_embeds(cfg, batch, device).to(
             torch.bfloat16)}
    step = make_prefill_step(model)
    step(b)                                     # warm-up, not counted
    K9.flash_attention.launches = 0             # counts of the main path
    lg = step(b)
    launched = K9.flash_attention.launches
    if launched != cfg.num_layers or not torch.isfinite(lg).all() \
            or lg.shape != (batch, 1, cfg.vocab_size):
        raise AssertionError(f"prefill step {cfg.name}: K9 launched "
                             f"{launched} times, logits {tuple(lg.shape)}, "
                             f"finite {bool(torch.isfinite(lg).all())}")
    ms = cuda_ms(lambda: step(b), 3, warmup=0)
    rows = frontend_rows(cfg) + text
    _log("serve", model=cfg.name, layers=cfg.num_layers, family=cfg.family,
         path="make_prefill_step", dtype="bfloat16", batch=batch,
         frontend_rows=frontend_rows(cfg), text=text, prefill_ms=ms,
         rows_per_s=batch * rows / ms * 1e3, k9_launches=launched)
    return dict(launches={"flash_attention_bf16": launched}, ms=ms)


def serve_encdec(cfg, device="cuda", batch=8, prompt_len=16,
                 new=64) -> dict:
    """The encoder-decoder at full size in bf16, through ``launch.steps``:
    ``batch`` rows of ``encoder_seq_len`` frames and a ``prompt_len``-token
    prompt; ``prefill`` (encode, then the prompt into the contiguous
    cache) and ``new`` - 1 greedy ``make_serve_step`` steps, ``new`` tokens
    a row; one ``make_prefill_step`` call on the same inputs, whose logits
    are held against the prefill's at the bf16 bound (relative to max(1,
    |logits|)).  Encode ms (the encoder alone, timed apart), prefill ms,
    decode step ms p50 and decode tok/s (rows x steps over the steps'
    time), synchronised around each call; K9's launches (bf16: one an
    encoder layer, one a decoder layer's cross-attention a prefill and a
    step), checked."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import kernel as K9
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import encdec
    bf16 = torch.bfloat16
    model = encdec.init(cfg, torch.Generator(device=device).manual_seed(SEED),
                        device=device, dtype=bf16)
    rng = np.random.default_rng(SEED + 8)
    prompt = torch.from_numpy(rng.integers(
        3, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)).to(device)
    frames = frontend_embeds(cfg, batch, device).to(bf16)
    serve_step = make_serve_step(model)

    def run(timed):
        cache = encdec.init_cache(cfg, batch, prompt_len + new, dtype=bf16,
                                  device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = encdec.prefill(model, prompt, cache,
                                   frontend_embeds=frames)
        tok = lg.argmax(-1)
        torch.cuda.synchronize()
        pre_ms = 1e3 * (time.perf_counter() - t0)
        toks, step_ms = [tok], []
        for i in range(new - 1):
            t0 = time.perf_counter()
            lg, cache = serve_step(tok, cache, prompt_len + i)
            tok = lg.argmax(-1)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            toks.append(tok)
        return pre_ms, step_ms, torch.cat(toks, 1), lg

    run(False)                                  # warm-up, not counted
    K9.flash_attention.launches = 0             # counts of the main path
    pre_ms, step_ms, toks, last = run(True)
    launched = K9.flash_attention.launches
    want = cfg.encoder_layers + cfg.num_layers * new
    if launched != want:
        raise AssertionError(f"serve {cfg.name}: K9 launched {launched} "
                             f"times, the steps imply {want}")
    if not (torch.isfinite(last).all() and ((toks >= 0)
                                            & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"serve {cfg.name}: non-finite logits or a "
                             f"token out of range")
    enc_ms = cuda_ms(lambda: encdec.encode(model, frames), 3)
    with torch.no_grad():
        cache = encdec.init_cache(cfg, batch, prompt_len, dtype=bf16,
                                  device=device)
        lg_pre, _ = encdec.prefill(model, prompt, cache,
                                   frontend_embeds=frames)
        lg_step = make_prefill_step(model)({"tokens": prompt,
                                            "frontend_embeds": frames})
    err = (lg_step.float() - lg_pre.float()).abs().max().item()
    tol = TOL["bfloat16"] * max(1.0, lg_pre.float().abs().max().item())
    if not err <= tol:
        raise AssertionError(f"serve {cfg.name}: make_prefill_step's logits "
                             f"differ from prefill's by {err} > {tol}")
    p50 = float(np.percentile(step_ms, 50))
    res = dict(params_m=sum(p.numel() for p in model.parameters()) / 1e6,
               batch=batch, frames=cfg.encoder_seq_len, prompt=prompt_len,
               new_tokens=new, encode_ms=enc_ms, prefill_ms=pre_ms,
               decode_step_ms_p50=p50,
               decode_tok_s=batch * len(step_ms) / (sum(step_ms) / 1e3),
               prefill_step_vs_prefill_max_abs_err=err, k9_launches=launched)
    _log("serve", model=cfg.name, layers=cfg.num_layers,
         encoder_layers=cfg.encoder_layers, d_model=cfg.d_model,
         family=cfg.family, path="launch.steps", dtype="bfloat16", **res)
    res["launches"] = {"flash_attention_bf16": launched}
    del model
    return res


def profile_decode(cfg, device="cuda", steps=8, block_size=16,
                   num_blocks=2048, prompt_len=512) -> dict:
    """``steps`` decode-only steps of 8 rows at ~``prompt_len`` + 18 live
    tokens each, timed without and then with torch.profiler; the device
    busy share (kernel time over the profiled window's wall time) and the
    top kernels by device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import get_model
    from repro_torch.serving import ContinuousEngine, Request
    model = get_model(cfg).init(
        cfg, torch.Generator(device=device).manual_seed(SEED), device=device,
        dtype=torch.bfloat16)
    eng = ContinuousEngine(cfg, model, max_batch=8, block_size=block_size,
                           num_blocks=num_blocks, max_len=prompt_len + 512,
                           prefill_chunk=256, device=device)
    rng = np.random.default_rng(SEED + 3)
    for _ in range(8):
        eng.submit(Request(prompt=rng.integers(3, cfg.vocab_size,
                                               size=prompt_len)
                           .astype(np.int32), max_new=2 * steps + 12))
    while any(s is None or s.pending is None for s in eng.slots):
        eng.step()                          # admit + prefill everything
    for _ in range(2):
        eng.step()                          # warm decode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()                          # the same window, unprofiled
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's device time repeats its kernels'
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)
    busy_us = sum(dev_us(e) for e in kernels)
    res = dict(step_ms=plain_wall / steps * 1e3,
               profiled_step_ms=wall / steps * 1e3,
               device_busy_ms_per_step=busy_us / steps / 1e3,
               device_busy_share=busy_us / 1e6 / wall,
               kernel_launches_per_step=sum(e.count for e in kernels) / steps)
    _log("profile", model=cfg.name, layers=cfg.num_layers,
         dsa=cfg.dsa is not None, prompt_len=prompt_len, **res)
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    # and the port's own kernels wherever they rank: their device time a
    # call, which CUDA events around back-to-back wrapper calls (the timing
    # phase) overstate when a launch is shorter than the wrapper's host work
    ours = [e for e in kernels if e not in top and any(
        m in e.key for m in ("paged_", "decode_split", "mla_tile",
                             "indexer_mma", "head_scan", "head_step",
                             "mamba_ssd"))]
    for e in top + ours:
        _log("profile.kernel", name=repr(e.key[:60]),
             device_ms_per_step=dev_us(e) / steps / 1e3,
             calls_per_step=e.count / steps,
             device_ms_per_call=dev_us(e) / max(e.count, 1) / 1e3)
    return res


# ---------------------------------------------------------------------------
# serving around the engine: the front-end, the spill tier and disaggregation
# ---------------------------------------------------------------------------

T_RESULT = 300.0     # seconds a request may take before it counts as lost


def _results(fe, handles) -> list:
    """Each handle's terminal outcome: the finished Request, or the typed
    error its ``result`` raised.  A request that does not end within
    ``T_RESULT`` is lost, and fails the run."""
    out = []
    for h in handles:
        try:
            out.append(fe.result(h, timeout=T_RESULT))
        except TimeoutError as e:
            raise AssertionError(f"frontend: request {h} lost: {e}") \
                from None
        except Exception as e:              # noqa: BLE001 - typed outcome
            out.append(e)
    return out


def _check_served(what, reqs, max_new, V) -> None:
    """Every request ended ok with ``max_new`` tokens in the vocabulary."""
    for r in reqs:
        if isinstance(r, Exception):
            raise AssertionError(f"{what}: a request failed: {r!r}")
        if r.status != "ok" or r.out is None or len(r.out) != max_new \
                or not ((r.out >= 0) & (r.out < V)).all():
            raise AssertionError(f"{what}: request {r.rid} ended "
                                 f"{r.status} with {r.out!r}")


def _healthy(what, fe, injected=0) -> None:
    """A front-end restarted exactly as often as faults were injected."""
    if fe.crashed is not None or fe.restarts != injected:
        raise AssertionError(f"{what}: {fe.restarts} restarts with "
                             f"{injected} injected (crashed="
                             f"{fe.crashed!r})")


def _timed_restores(tier) -> list:
    """Wrap a spill tier's ``restore`` with CUDA events (this script only):
    each restore's device milliseconds, host milliseconds of the call (the
    copies are enqueued, not waited for) and bytes are appended to the
    returned list."""
    import torch
    seen = []
    restore = tier.restore

    def timed(keyed, blocks):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        restore(keyed, blocks)
        host_ms = (time.perf_counter() - t0) * 1e3
        e1.record()
        e1.synchronize()
        seen.append((e0.elapsed_time(e1), host_ms,
                     sum(e.nbytes for _, e in keyed)))
    tier.restore = timed
    return seen


def _gqa_kernels():
    from repro_torch.kernels.paged_attention import kernel as KD
    from repro_torch.kernels.paged_attention import prefill as KP
    return [KD.paged_decode_gqa, KP.paged_prefill_gqa]


def frontend_parity(cfg, device="cuda", block_size=16, chunk=64) -> dict:
    """fp32 greedy tokens through ``AsyncFrontend``, with the host spill
    tier on a pool too small to keep the 200-token system prompt between
    its waves (so it is demoted and then restored), and through
    ``DisaggServer`` with ``pd_threshold`` below the long prompts, each
    against the static ServingEngine oracle on the plain route wherever
    the top-2 margin is >= 1e-3 (spill on and spill off held equal there
    too).  Waves: two prompts on the system prompt, two unrelated
    560-token fillers that need the pool, then two more prompts on the
    system prompt and two unrelated short ones; each wave drains before
    the next is submitted."""
    import numpy as np
    import torch
    from repro_torch.faults import FaultInjector
    from repro_torch.models import get_model
    from repro_torch.serving import (AsyncFrontend, ContinuousEngine,
                                     DisaggServer, Request, ServingEngine)
    model = get_model(cfg).init(
        cfg, torch.Generator(device=device).manual_seed(SEED), device=device,
        dtype=torch.float32)
    rng = np.random.default_rng(SEED + 4)
    V = cfg.vocab_size
    sys_p = rng.integers(3, V, size=200)
    waves = [[np.concatenate([sys_p, rng.integers(3, V, size=n)])
              for n in (7, 30)],
             [rng.integers(3, V, size=560) for _ in range(2)],
             [np.concatenate([sys_p, rng.integers(3, V, size=n)])
              for n in (61, 3)] + [rng.integers(3, V, size=n)
                                   for n in (3, 90)]]
    waves = [[(p.astype(np.int32), 6 + i % 4) for i, p in enumerate(w)]
             for w in waves]
    flat = [pm for w in waves for pm in w]
    max_len = 640
    oracle = ServingEngine(cfg, model, max_batch=1, max_len=max_len,
                           device=device)
    oreqs = [Request(prompt=p, max_new=m) for p, m in flat]
    with plain_route():
        oracle.serve(oreqs)
        margins = [_margins_ok(model, p, o.out, device)
                   for (p, _), o in zip(flat, oreqs)]
    if not any(margins):
        raise AssertionError("frontend.parity: no prompt had a top-2 margin")
    kernels = _gqa_kernels()
    before = [k.launches for k in kernels]
    kw = dict(max_batch=2, block_size=block_size, max_len=max_len,
              prefill_chunk=chunk, device=device)

    def run(fe):
        outs = []
        try:
            for wave in waves:
                hs = [fe.submit(p, max_new=m) for p, m in wave]
                reqs = _results(fe, hs)
                for r, (_, m) in zip(reqs, wave):
                    _check_served("frontend.parity", [r], m, V)
                    outs.append(r.out)
        finally:
            fe.close(timeout=T_RESULT)
        return outs

    def held(what, outs):
        for o, ok, got in zip(oreqs, margins, outs):
            if ok and not np.array_equal(got, o.out):
                raise AssertionError(f"frontend.parity: {what} "
                                     f"{got.tolist()} != oracle "
                                     f"{o.out.tolist()}")

    res = {}
    for spill in (False, True):
        eng = ContinuousEngine(cfg, model, num_blocks=40, spill=spill,
                               spill_blocks=256, faults=FaultInjector(""),
                               **kw)
        fe = AsyncFrontend(eng, max_restarts=0)
        outs = run(fe)
        _healthy("frontend.parity", fe)
        held("spill" if spill else "frontend", outs)
        reg = fe.registry
        if spill:
            res.update(demotions=reg.counter("spill.demotions"),
                       restores=reg.counter("spill.restores"),
                       restored_blocks=reg.counter("spill.restored_blocks"))
            if res["restores"] <= 0 or res["demotions"] <= 0:
                raise AssertionError(f"frontend.parity: the system prompt "
                                     f"was not demoted and restored: {res}")
            for a, b, ok in zip(outs, off, margins):
                if ok and not np.array_equal(a, b):
                    raise AssertionError("frontend.parity: spill on != off")
        else:
            off = outs
            res["cached_tokens_spill_off"] = eng.stats["cached_tokens"]
        del fe, eng
    srv = DisaggServer(cfg, model, decode_kw=dict(kw, num_blocks=256),
                       pd_threshold=200, faults=FaultInjector(""),
                       prefill_faults=FaultInjector(""),
                       heartbeat_timeout_s=60.0)
    try:
        outs = []
        for wave in waves:
            hs = [srv.submit(p, max_new=m) for p, m in wave]
            for h in hs:
                outs.append(srv.result(h, timeout=T_RESULT).out)
        st = dict(srv.stats)
        _healthy("frontend.parity disagg", srv.decode_frontend)
    finally:
        srv.close(timeout=T_RESULT)
    held("disagg", outs)
    if st["migrations"] <= 0 or st["colocated_fallbacks"] \
            or st["prefill_respawns"] or st["tier_down_events"]:
        raise AssertionError(f"frontend.parity: disagg {st}")
    if device != "cpu" and not _all_launched(kernels, before):
        raise AssertionError("frontend.parity: K1 or K2 never launched")
    res.update(compared=sum(margins), skipped=len(margins) - sum(margins),
               pd_routes=st["pd_routes"], migrations=st["migrations"],
               migrated_blocks=st["migrated_blocks"],
               colocated_routes=st["colocated_routes"])
    _log("frontend.parity", model=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, dtype="float32", **res)
    del oracle, model
    return res


def frontend_serve(cfg, prompt_lens, model, direct, device="cuda",
                   block_size=16, num_blocks=2048, chunk=256, max_new=32,
                   shared=200, crash_at=12, xfer_faults=2) -> dict:
    """The serve mix through the serving layers around the engine at full
    width and depth in bf16, on ``model`` (the serve phase's): the
    front-end (TTFT / TPOT p50 beside the engine-direct run ``direct``);
    again with a weight push mid-run (the requests admitted before it keep
    version 0, those submitted after take version 1); with a serve-loop
    crash injected (``crash@crash_at``: one restart, zero lost, every
    failure ``EngineRestarted``, those requests served again after); a
    spill run on a pool of two of the longest requests (the mix, two
    fillers that need the whole pool, the mix again: demotions, restores,
    restore GB/s from CUDA events around each restore); a disaggregated
    run with ``pd_threshold`` 256 (migrations > 0, no fallback) and one with
    ``xfer@0..{xfer_faults - 1}`` and no retries (one fallback an injected
    fault).  K1's and K2's launches are counted over each run and
    summed."""
    import collections
    import numpy as np
    from repro_torch.faults import FaultInjector
    from repro_torch.serving import (AsyncFrontend, ContinuousEngine,
                                     DisaggServer, EngineRestarted)
    V = cfg.vocab_size
    sys_p, prompts = _mix_prompts(V, prompt_lens, shared)
    max_len = max(prompt_lens) + max_new + chunk
    kw = dict(max_batch=8, block_size=block_size, num_blocks=num_blocks,
              max_len=max_len, prefill_chunk=chunk, device=device)
    kernels = _gqa_kernels()
    launches = collections.Counter()
    res = {}

    def counted(label, fn):
        for k in kernels:
            k.launches = 0                     # counts of this run
        out = fn()
        got = {k.__name__: k.launches for k in kernels}
        if device != "cpu" and 0 in got.values():
            raise AssertionError(f"frontend {label}: a kernel never "
                                 f"launched: {got}")
        launches.update(got)
        return out

    def engine(**extra):
        return ContinuousEngine(cfg, model, faults=extra.pop(
            "faults", FaultInjector("")), **dict(kw, **extra))

    # 1-2: the mix, then the mix with a push mid-run
    fe = AsyncFrontend(engine(), max_restarts=0)
    try:
        _check_served("frontend", _results(fe, [fe.submit(sys_p,
                                                          max_new=4)]),
                      4, V)                  # the engine-direct warm-up
        fe.call(lambda: fe.registry.reset_histograms("engine"))

        def mix():
            t0 = time.perf_counter()
            reqs = _results(fe, [fe.submit(p, max_new=max_new)
                                 for p in prompts])
            _check_served("frontend", reqs, max_new, V)
            return time.perf_counter() - t0
        wall = counted("mix", mix)
        lat = fe.latency_summary()
        res.update(wall_s=wall, ttft_p50_ms=lat["ttft_ms"]["p50"],
                   tpot_p50_ms=lat["tpot_ms"]["p50"],
                   ttft_p50_ms_engine=direct["ttft_p50_ms"],
                   tpot_p50_ms_engine=direct["tpot_p50_ms"],
                   wall_s_engine=direct["wall_s"])

        def pushed():
            hs = [fe.submit(p, max_new=max_new) for p in prompts]
            t0 = time.perf_counter()
            while not all(p.done or len(p.tokens) > 0
                          for p in map(fe.poll, hs)):
                if time.perf_counter() - t0 > T_RESULT:
                    raise AssertionError("frontend push: never admitted")
                time.sleep(0.002)
            fe.push_weights(model, 1)
            late = [fe.submit(p, max_new=max_new) for p in prompts[:2]]
            early, late = _results(fe, hs), _results(fe, late)
            _check_served("frontend push", early + late, max_new, V)
            if any(r.out_version != 0 for r in early) or \
                    any(r.out_version != 1 for r in late):
                raise AssertionError("frontend push: version stamps "
                                     f"{[r.out_version for r in early]} "
                                     f"{[r.out_version for r in late]}")
        counted("push", pushed)
        st = fe.stats
        if st["weight_pushes"] != 1 or fe.version != 1:
            raise AssertionError(f"frontend push: {dict(st)}")
        res.update(push_version_refused=fe.engine.prefix.stats[
            "version_refused"])
        _healthy("frontend", fe)
    finally:
        fe.close(timeout=T_RESULT)
    del fe
    _free()

    # 3: a serve-loop crash mid-run
    faults = FaultInjector(f"crash@{crash_at}")
    fe = AsyncFrontend(engine(faults=faults), max_restarts=1)
    try:
        first = fe.engine

        def crashed():
            outcomes = _results(fe, [fe.submit(p, max_new=max_new)
                                     for p in prompts])
            bad = [o for o in outcomes if isinstance(o, Exception)
                   and not isinstance(o, EngineRestarted)]
            if bad:
                raise AssertionError(f"frontend crash: untyped {bad!r}")
            again = [p for p, o in zip(prompts, outcomes)
                     if isinstance(o, EngineRestarted)]
            _check_served("frontend crash", [o for o in outcomes if not
                                             isinstance(o, Exception)],
                          max_new, V)
            redo = _results(fe, [fe.submit(p, max_new=max_new)
                                 for p in again])
            _check_served("frontend crash (served again)", redo, max_new, V)
            return len(again)
        restarted = counted("crash", crashed)
        _healthy("frontend crash", fe, injected=faults.fired.get("crash", 0))
        if fe.restarts != 1 or restarted < 1 or first.pool:
            raise AssertionError(f"frontend crash: restarts {fe.restarts}, "
                                 f"failed {restarted}, old pool released "
                                 f"{not first.pool}")
        res.update(restarts=fe.restarts, restarted_requests=restarted,
                   lost=0)
        del first
    finally:
        fe.close(timeout=T_RESULT)
    del fe
    _free()

    # 4: the spill tier on a pool that cannot keep the mix
    # two of the longest requests fill the pool: the fillers push out all
    # the mix left cached
    pool = 2 * -(-(max(prompt_lens) + max_new) // block_size)
    fe = AsyncFrontend(engine(num_blocks=pool, spill=True), max_restarts=0)
    try:
        restores = _timed_restores(fe.engine.spill_tier)
        frng = np.random.default_rng(SEED + 5)
        fillers = [frng.integers(3, V, size=max(prompt_lens)).astype(
            np.int32) for _ in range(2)]

        def spilled():
            for wave in (prompts, fillers, prompts):
                reqs = _results(fe, [fe.submit(p, max_new=max_new)
                                     for p in wave])
                _check_served("frontend spill", reqs, max_new, V)
        counted("spill", spilled)
        reg = fe.registry
        ms = sum(t for t, _, _ in restores)
        nbytes = sum(b for _, _, b in restores)
        res.update(spill_pool_blocks=pool,
                   spill_demotions=reg.counter("spill.demotions"),
                   spill_restores=reg.counter("spill.restores"),
                   spill_restored_blocks=reg.counter("spill.restored_blocks"),
                   restore_ms=ms, restore_gb_s=nbytes / ms / 1e6 if ms
                   else 0.0, restore_host_ms=sum(h for _, h, _ in restores),
                   restored_mib=nbytes / 2 ** 20)
        if res["spill_restores"] <= 0:
            raise AssertionError(f"frontend spill: no restore: {res}")
        _healthy("frontend spill", fe)
    finally:
        fe.close(timeout=T_RESULT)
    del fe
    _free()

    # 5-6: disaggregated prefill/decode, healthy, then with xfer faults
    for label, spec in (("disagg", ""),
                        ("disagg xfer", f"xfer@0..{xfer_faults - 1}")):
        router = FaultInjector(spec)
        srv = DisaggServer(cfg, model, decode_kw=dict(kw), pd_threshold=256,
                           migrate_retries=0, faults=router,
                           prefill_faults=FaultInjector(""),
                           heartbeat_timeout_s=60.0)
        try:
            def split():
                reqs = _results(srv, [srv.submit(p, max_new=max_new)
                                      for p in prompts])
                _check_served(f"frontend {label}", reqs, max_new, V)
            counted(label, split)
            st = dict(srv.stats)
            mig = srv.registry.summary("disagg.migrate_ms")
            _healthy(f"frontend {label}", srv.decode_frontend)
        finally:
            srv.close(timeout=T_RESULT)
        injected = router.fired.get("xfer", 0)
        if st["colocated_fallbacks"] != injected \
                or st["migrations"] != st["pd_routes"] - injected \
                or (not spec and st["migrations"] <= 0) \
                or st["prefill_respawns"] or st["tier_down_events"] \
                or injected != (xfer_faults if spec else 0):
            raise AssertionError(f"frontend {label}: {st}, {injected} xfer "
                                 f"faults injected")
        tag = "disagg" if not spec else "xfer"
        res.update({f"{tag}_pd_routes": st["pd_routes"],
                    f"{tag}_migrations": st["migrations"],
                    f"{tag}_migrated_blocks": st["migrated_blocks"],
                    f"{tag}_migrate_ms_p50": mig["p50"],
                    f"{tag}_fallbacks": st["colocated_fallbacks"],
                    f"{tag}_injected_faults": injected})
        del srv
        _free()
    _log("frontend", model=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, dtype="bfloat16", requests=len(prompts),
         **res, **{f"{k}_launches": v for k, v in launches.items()})
    res["launches"] = launches
    return res


# ---------------------------------------------------------------------------
# asynchronous agent RL: rollouts through the front-end, the IS trainer
# ---------------------------------------------------------------------------

def _rl_tasks(V, sys_p, problem, max_new, ratios=(("copy", 0.6),
                                                  ("reverse", 0.4))):
    """The RL toy tasks as task services: a shared system prompt, then
    ``problem`` tokens the answer is made of (copied or reversed), every
    prompt exactly ``len(sys_p) + problem`` tokens long, rewarded by the
    generated prefix that matches the answer."""
    import numpy as np
    from repro_torch.async_rl import TaskService
    from repro_torch.data.synthetic import TASKS
    from repro_torch.rl.rewards import prefix_reward

    def sampler(name):
        def sample(rng):
            x, answer = TASKS[name](rng, problem, V)
            return {"prompt": np.concatenate([sys_p, x]).astype(np.int32),
                    "answer": answer}
        return sample

    def reward(prob, gen):
        return prefix_reward(gen[:len(prob["answer"])], prob["answer"]), False

    return [TaskService(name, sampler(name), reward, max_new=max_new,
                        ratio=r) for name, r in ratios]


def _stop_workers(orch) -> None:
    """Stop the orchestrator and wait until every worker has returned (a
    worker mid-group finishes its rollouts first)."""
    orch.stop()
    for t in orch._threads:
        t.join(timeout=T_RESULT)
        if t.is_alive():
            raise AssertionError("rl: a rollout worker did not stop")


def _await_version(fe, version) -> None:
    """The front-end's engine applied the push of ``version`` (at its drain
    barrier)."""
    t0 = time.perf_counter()
    while fe.version != version:
        if time.perf_counter() - t0 > T_RESULT:
            raise AssertionError(f"rl: engine at version {fe.version}, the "
                                 f"trainer pushed {version}")
        time.sleep(0.01)


def rl_parity(cfg, device="cuda", group=8, n_groups=2, shared=48,
              problem=16, max_new=16, gate=True) -> dict:
    """fp32, TF32 off: one ``RolloutEngine`` (fp32 snapshot) serving one
    orchestrator worker through the front-end, two GRPO groups of 8 at
    temperature 1 on prompts of exactly ``prompt_pad`` tokens, then one
    ``AsyncTrainer.train_on`` before any push.  The behaviour logprobs the
    engine captured and the trainer's recomputed ones are the same
    function of the same weights: every token's gap <= 1e-3, the step's
    mean ratio within 1e-3 of 1 and every token kept.  A wrong position, a
    prompt padded with tokens the rollout never saw, a version mixed into
    a trajectory or a wrong logits row would each break it.  With
    ``gate=False`` (DSA's randomized top-k: the engine's paged selection
    and the trainer's draw other noise, GLM-5 §3.2) the gaps and the kept
    fraction are recorded, not held.

    The rewards on random weights are all 0, so the groups get scripted
    rewards that differ inside each group (i / group for the i-th): the
    step runs on nonzero advantages, on the kernel route and on the plain
    route from the same weights (``_TopkAlign`` aligns DSA's near-tie
    picks), and the parameters after it must have moved and agree within
    ``train_parity``'s bound (``_hold_step``, on the clipped gradients
    each route handed Muon)."""
    import numpy as np
    import torch
    from repro_torch.async_rl import AsyncTrainer, Orchestrator, RolloutEngine
    from repro_torch.async_rl.trainer import pack_groups
    from repro_torch.models import transformer as T
    from repro_torch.models.losses import token_logprobs
    from repro_torch.optim import muon
    model = T.init(cfg, torch.Generator(device=device).manual_seed(SEED),
                   device=device, dtype=torch.float32)
    V, plen = cfg.vocab_size, shared + problem
    sys_p = np.random.default_rng(SEED + 5).integers(3, V, size=shared)
    eng = RolloutEngine(cfg, model, engine_dtype=torch.float32, seed=SEED,
                        device=device)
    kw = dict(max_batch=8, block_size=16, num_blocks=256, max_len=512)
    orch = Orchestrator([eng], group_size=group, backend="serving",
                        serving_kw=kw)
    for task in _rl_tasks(V, sys_p.astype(np.int32), problem, max_new):
        orch.register(task)
    lr, axes = 1e-3, T.param_axes(model)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    try:
        orch.start(n_workers=1)
        if not orch.wait_for_groups(n_groups, timeout_s=T_RESULT):
            raise AssertionError(f"rl.parity: groups not ready "
                                 f"{orch.worker_errors}")
        _stop_workers(orch)
        if orch.worker_errors:
            raise AssertionError(f"rl.parity: {orch.worker_errors}")
        groups = orch.buffer.pop_groups(n_groups, 0)
        rewards = [t.reward for g in groups for t in g]
        for g in groups:                      # nonzero advantages
            for i, t in enumerate(g):
                t.reward = i / len(g)
        batch = pack_groups(groups, max_new, plen)
        if any(len(t.prompt) != plen or t.versions != [0]
               for g in groups for t in g):
            raise AssertionError("rl.parity: a prompt or version off")
        with torch.no_grad():
            toks = torch.from_numpy(batch["tokens"]).to(device)
            lp = token_logprobs(T.logits(model, toks)[:, plen - 1:-1],
                                toks[:, plen:]).cpu().numpy()
        live = batch["mask"] > 0
        gaps = np.abs(lp - batch["lp_rollout"])[live]

        def one_step():
            """``train_on`` from the start weights with a fresh trainer;
            returns its metrics, the clipped gradients and the weights."""
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(start[k])
            trainer = AsyncTrainer(cfg, model, axes, engines=[eng], lr=lr,
                                   push_every=2, device=device)
            grads, clip = {}, muon.global_norm_clip

            def recording(g, max_norm):
                g, norm = clip(g, max_norm)
                grads.update({k: v.detach().clone() for k, v in g.items()})
                return g, norm
            muon.global_norm_clip = recording
            try:
                m = trainer.train_on(groups, pad_to=max_new, prompt_pad=plen)
            finally:
                muon.global_norm_clip = clip
            return m, grads, {k: p.detach().clone()
                              for k, p in model.named_parameters()}

        align = cfg.dsa is not None and cfg.dsa.selector == "token"
        with _TopkAlign(align) as kernel_topk:
            m, grads_k, after_k = one_step()
        with plain_route(), _TopkAlign(align, kernel_topk.calls) as plain_k:
            m_p, grads_p, after_p = one_step()
    finally:
        orch.stop()
        if eng._frontend is not None:
            eng._frontend.close(timeout=T_RESULT)
    failures = []
    p_err = _hold_step(after_k, after_p, grads_k, grads_p, axes, lr,
                       failures)
    moved = max((after_k[k] - start[k]).abs().max().item() for k in start)
    res = dict(groups=len(groups), group_size=group, prompt_pad=plen,
               max_new=max_new, tokens=int(live.sum()),
               max_logprob_gap=float(gaps.max()),
               mean_logprob_gap=float(gaps.mean()),
               tokens_past_1e_3=int((gaps > 1e-3).sum()),
               mean_ratio=m["ratio"], kept=m["kept"], loss=m["loss"],
               grad_norm=m["grad_norm"], rollout_rewards=repr(rewards),
               scripted_rewards=repr([t.reward for t in groups[0]]),
               loss_plain=m_p["loss"], max_param_moved=moved,
               max_param_err=p_err, near_tie_indices=plain_k.near)
    _log("rl.parity", model=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, dtype="float32", dsa=cfg.dsa is not None,
         top_k=cfg.dsa.top_k if cfg.dsa is not None else None,
         deterministic_topk=cfg.dsa.deterministic_topk
         if cfg.dsa is not None else None, gated=gate, **res)
    if gate and not (res["max_logprob_gap"] <= 1e-3
                     and abs(m["ratio"] - 1.0) <= 1e-3 and m["kept"] == 1.0):
        raise AssertionError(f"rl.parity: {res}")
    if not (math.isfinite(m["loss"]) and moved > 0 and m["grad_norm"] > 0):
        raise AssertionError(f"rl.parity: the step on nonzero advantages "
                             f"did not move the weights: {res}")
    if failures:
        raise AssertionError("rl.parity, kernel vs plain step: "
                             + "; ".join(failures))
    del eng, model, start, after_k, after_p, grads_k, grads_p
    return res


def rl_run(cfg, device="cuda", steps=4, groups_a_step=2, group=8,
           shared=216, problem=16, max_new=16, push_every=2, tau=4,
           loop_new=8) -> dict:
    """The asynchronous RL loop at full width: an fp32 trainer (Muon
    Split, lr 1e-3, a push every ``push_every`` steps and the optimizer
    reset after it), two bf16 ``RolloutEngine``s serving two orchestrator
    workers through their front-ends (K1 decode steps, K2 spans; the
    copy and reverse tasks, 0.6 / 0.4, on a shared 216-token system
    prompt), ``steps`` steps of ``groups_a_step`` groups popped within
    ``tau`` of the trainer's version; then one group through the loop
    backend (``generate``: a bf16 re-forward a token, K9's bf16 route).
    Hard checks: losses finite, no worker error, every popped group within
    tau, both engines at the last pushed version once drained, K9's
    launches those the depth implies (fp32: one a layer a trainer step;
    bf16: one a layer a loop-backend token), K1 and K2 launched, and the
    first step's mean ratio within [0.9, 1.1] (bf16 rollouts against the
    fp32 trainer, before any push)."""
    import numpy as np
    import torch
    from repro_torch.async_rl import AsyncTrainer, Orchestrator, RolloutEngine
    from repro_torch.kernels.flash_attention import kernel as K9
    from repro_torch.models import transformer as T
    K1, K2 = _gqa_kernels()
    V, plen = cfg.vocab_size, shared + problem
    sys_p = np.random.default_rng(SEED + 6).integers(3, V, size=shared)
    torch.cuda.reset_peak_memory_stats()
    model = T.init(cfg, torch.Generator(device=device).manual_seed(SEED),
                   device=device, dtype=torch.float32)
    engines = [RolloutEngine(cfg, model, seed=SEED + i, device=device)
               for i in range(2)]
    kw = dict(max_batch=8, block_size=16, num_blocks=256, max_len=512)
    orch = Orchestrator(engines, group_size=group, staleness_tau=tau,
                        backend="serving", serving_kw=kw)
    tasks = _rl_tasks(V, sys_p.astype(np.int32), problem, max_new)
    for task in tasks:
        orch.register(task)
    trainer = AsyncTrainer(cfg, model, T.param_axes(model), engines=engines,
                           lr=1e-3, push_every=push_every, device=device)
    push_ms = []
    for e in engines:                         # this script only: timing
        push = e.push_weights

        def timed(params, version, push=push):
            t0 = time.perf_counter()
            push(params, version)
            push_ms.append((time.perf_counter() - t0) * 1e3)
        e.push_weights = timed
    for k in (K1, K2, K9.flash_attention):
        k.launches = 0                        # counts of the main path
    hist, step_ms, stale, k9_train = [], [], [], 0
    try:
        t0 = time.perf_counter()
        orch.start(n_workers=2)
        for _ in range(steps):
            popped = []
            while len(popped) < groups_a_step:
                if not orch.wait_for_groups(groups_a_step - len(popped),
                                            timeout_s=T_RESULT):
                    raise AssertionError(f"rl: groups not ready "
                                         f"{orch.worker_errors}")
                popped += orch.buffer.pop_groups(
                    groups_a_step - len(popped), trainer.version)
            stale += [trainer.version - t.version_min
                      for g in popped for t in g]
            before = K9.flash_attention.launches
            ts = time.perf_counter()
            hist.append(trainer.train_on(popped, pad_to=max_new,
                                         prompt_pad=plen))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - ts) * 1e3)
            k9_train += K9.flash_attention.launches - before
        loop_wall = time.perf_counter() - t0
        reg = orch.registry
        rollout_tokens = reg.counter("rollout.tokens")
        groups_done = reg.counter("orchestrator.groups")
        _stop_workers(orch)
        for e in engines:
            fe = e.serving_frontend(**kw)
            fe.flush(timeout=T_RESULT)
            _await_version(fe, trainer.version)
        served = {k.__name__: k.launches for k in (K1, K2)}
        hst = reg.histogram("rollout.staleness")
        cached = engines[0].serving_engine(**kw).stats["cached_tokens"]
        # one group through the loop backend: a full bf16 re-forward a token
        prob = tasks[0].sample_problem(np.random.default_rng(SEED + 7))
        before = K9.flash_attention.launches
        tl = time.perf_counter()
        loop_tokens = 0
        for _ in range(group):
            rid = engines[0].gateway.new_rollout("copy")
            loop_tokens += len(engines[0].generate(rid, prob["prompt"],
                                                   loop_new))
            t = engines[0].gateway.finish(rid, "copy", prob["prompt"], 0.0)
            if t.versions != [trainer.version] * len(t.versions):
                raise AssertionError(f"rl: loop versions {t.versions}")
        torch.cuda.synchronize()
        loop_ms = (time.perf_counter() - tl) * 1e3
        k9_loop = K9.flash_attention.launches - before
    finally:
        orch.stop()
        for e in engines:
            if e._frontend is not None:
                e._frontend.close(timeout=T_RESULT)
    losses = [h["loss"] for h in hist]
    want_train = cfg.num_layers * steps
    want_loop = cfg.num_layers * loop_tokens
    res = dict(
        steps=steps, groups_a_step=groups_a_step, group_size=group,
        prompt_pad=plen, max_new=max_new, push_every=push_every,
        losses=[round(x, 5) for x in losses],
        ratio=[round(h["ratio"], 5) for h in hist],
        kept=[round(h["kept"], 5) for h in hist],
        mean_reward=[round(h["mean_reward"], 4) for h in hist],
        grad_norm=[round(h["grad_norm"], 4) for h in hist],
        step_ms=[round(x, 1) for x in step_ms],
        step_ms_after_first=float(np.mean(step_ms[1:])),
        push_ms=[round(x, 1) for x in push_ms],
        rollout_tokens=rollout_tokens, rollout_groups=groups_done,
        rollout_tok_s=rollout_tokens / loop_wall,
        rollout_groups_s=groups_done / loop_wall, loop_wall_s=loop_wall,
        staleness_counts=dict(zip(
            [f"<={b:g}" for b in hst.boundaries] + ["more"], hst.counts)),
        popped_staleness_max=max(stale), cached_tokens=cached,
        worker_errors=len(orch.worker_errors),
        engine_versions=[e.serving_frontend(**kw).version for e in engines],
        trainer_version=trainer.version,
        loop_tokens=loop_tokens, loop_ms=loop_ms,
        max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        k1_launches=served["paged_decode_gqa"],
        k2_launches=served["paged_prefill_gqa"],
        k9_fp32_launches=k9_train, k9_bf16_launches=k9_loop)
    _log("rl", model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         trainer="float32", rollouts="bfloat16",
         **{k: repr(v) if isinstance(v, (list, dict)) else v
            for k, v in res.items()})
    bad = []
    if not all(math.isfinite(x) for x in losses):
        bad.append("losses not finite")
    if orch.worker_errors:
        bad.append(f"worker errors {orch.worker_errors}")
    if max(stale) > tau:
        bad.append(f"a popped group {max(stale)} versions stale > {tau}")
    if res["engine_versions"] != [trainer.version] * 2 \
            or trainer.version != steps:
        bad.append("engines not at the last pushed version")
    if k9_train != want_train or k9_loop != want_loop:
        bad.append(f"K9 launches fp32 {k9_train} (want {want_train}), bf16 "
                   f"{k9_loop} (want {want_loop})")
    if not served["paged_decode_gqa"] or not served["paged_prefill_gqa"]:
        bad.append(f"K1/K2 never launched {served}")
    if not 0.9 <= hist[0]["ratio"] <= 1.1:
        bad.append(f"first step's mean ratio {hist[0]['ratio']}")
    if bad:
        raise AssertionError(f"rl: {'; '.join(bad)}")
    res["launches"] = dict(served, flash_attention=k9_train,
                           flash_attention_bf16=k9_loop)
    del trainer, engines, model, orch
    return res


def mtp_logprobs(cfg, model, prompt_lens, device="cuda", block_size=16,
                 num_blocks=2048, chunk=256, max_new=32, shared=200,
                 spec=3, gate=True) -> dict:
    """Logprob capture through speculation (GLM-5 + MTP, bf16): the serve
    mix greedy with ``true_logprobs`` at ``spec_steps=0`` and ``spec``; the
    logprobs finite and <= 0.  With ``gate`` the spec run's logprobs (the
    bonus tokens' from the verify span's logits, K4) are within the bf16
    tolerance 2e-2 of the spec-off run's (the decode steps', K3),
    relative to the logprob where it passes 1 (a logprob near -8 is a
    logit rounded to 8 bits minus a logsumexp), at every position up to
    and including the first token the two runs choose differently.  Both
    runs emit their argmax, whose true logprob is the distribution's
    largest: where the tokens part, the two largest logprobs still agree
    within the tolerance, so a parting is a near-tie (a span and a decode
    step sum in other orders), and a wrong logits row would break it.
    Without ``gate`` the gaps are printed only: with an MoE layer in bf16
    a router near-tie sends a token to other experts on one path, which
    moves its logits by more than rounding."""
    import numpy as np
    from repro_torch.serving import ContinuousEngine, Request
    _, prompts = _mix_prompts(cfg.vocab_size, prompt_lens, shared)
    max_len = max(prompt_lens) + max_new + chunk
    runs = {}
    for s in (0, spec):
        eng = ContinuousEngine(cfg, model, max_batch=8,
                               block_size=block_size, num_blocks=num_blocks,
                               max_len=max_len, prefill_chunk=chunk,
                               spec_steps=s, capture_logprobs=True,
                               true_logprobs=True, device=device)
        reqs = [Request(prompt=p, max_new=max_new) for p in prompts]
        eng.serve(reqs)
        runs[s] = reqs
        accept = eng.rolling_accept_length
        del eng
    equal, worst, worst_rel, first_part = 0, 0.0, 0.0, []
    for a, b in zip(runs[0], runs[spec]):
        if a.out_logprobs is None or b.out_logprobs is None \
                or len(b.out_logprobs) != max_new:
            raise AssertionError("serve.mtp logprobs: none captured")
        same = a.out == b.out
        n = max_new if same.all() else int(np.argmin(same)) + 1
        equal += bool(same.all())
        if not same.all():
            first_part.append(n - 1)
        gap = np.abs(a.out_logprobs[:n] - b.out_logprobs[:n])
        rel = gap / np.maximum(1.0, np.abs(a.out_logprobs[:n]))
        worst = max(worst, float(gap.max()))
        worst_rel = max(worst_rel, float(rel.max()))
    res = dict(spec_steps=spec, requests=len(prompts), tokens_equal=equal,
               first_parting=repr(first_part), accept_length=accept,
               max_logprob_gap=worst, max_logprob_gap_rel=worst_rel,
               mean_logprob=float(np.mean(np.concatenate(
                   [r.out_logprobs for r in runs[0]]))))
    dtype = str(next(model.parameters()).dtype).split(".")[1]
    _log("serve.mtp", what="logprobs", model=cfg.name, layers=cfg.num_layers,
         experts=cfg.num_experts, first_k_dense=cfg.first_k_dense,
         dtype=dtype, **res)
    if not all(np.isfinite(r.out_logprobs).all()
               and (r.out_logprobs <= 1e-6).all()
               for r in runs[0] + runs[spec]) \
            or (gate and worst_rel > TOL[dtype]):
        raise AssertionError(f"serve.mtp logprobs: {res}")
    return res


def time_k9_loop(cfg, prompt_pad, loop_new, device="cuda", reps=20) -> dict:
    """K9's bf16 route (the bf16 tensor-core tile, at the parts its wrapper
    picks) at the loop backend's shape: one sequence of ``prompt_pad +
    loop_new`` rounded up to 16 (the rollout buffer), the config's heads,
    causal; held against its plain version in bf16 and timed beside it and
    SDPA (is_causal, KV heads repeated once before the timed loop; its
    CUDA-event time and its device time from the same graph replay as the
    kernel's); bound by bytes or bf16 flops."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K9
    gen = torch.Generator(device=device).manual_seed(SEED)
    B, S = 1, _round_up(prompt_pad + loop_new, 16)
    H, KVH, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(bf)

    q, k, v = rnd(B, S, H, d), rnd(B, S, KVH, d), rnd(B, S, KVH, d)
    qs = q.transpose(1, 2).contiguous()
    ks = k.repeat_interleave(H // KVH, 2).transpose(1, 2).contiguous()
    vs = v.repeat_interleave(H // KVH, 2).transpose(1, 2).contiguous()
    fn = K9.flash_attention
    G = H // KVH
    parts = K9.bf16_parts(d, S * G, B * KVH, q.device)

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    out = {"flash_attention_bf16": dict(
        ms=cuda_ms(lambda: fn(q, k, v), reps),
        device_ms=graph_ms(lambda: fn(q, k, v), reps),
        plain_ms=cuda_ms(lambda: K9.reference(q, k, v), reps),
        library_ms=cuda_ms(sdpa, reps),
        extra=dict(host_us=host_us(lambda: fn(q, k, v)),
                   library_device_ms=graph_ms(sdpa, reps), parts=parts),
        max_abs_err=_hold("K9 loop-shape", fn(q, k, v),
                          K9.reference(q, k, v), bf),
        max_abs_err_fp32=_hold("K9 loop-shape", fn(*(
            x.float() for x in (q, k, v))), K9.reference(
                *(x.float() for x in (q, k, v))), torch.float32),
        flops=4 * B * H * S * S * d / 2,
        bytes=2 * (2 * q.numel() + k.numel() + v.numel()),
        shape=f"B={B} S={S} H={H} KVH={KVH} d={d} causal "
              f"body=mma_tile::attention_kernel<DenseKV> parts={parts}")}
    _bounds(out)
    return out


# ---------------------------------------------------------------------------
# the training path: K7, K9, K10, the train step and the trainer
# ---------------------------------------------------------------------------

TRAIN_KERNELS = ("lightning_indexer", "flash_attention", "chunked_ce",
                 "block_sparse_attention", "mamba_scan_model",
                 "mamba_scan_heads")


def train_kernel_wrappers() -> dict:
    """name -> (module, wrapper, plain version) of the training kernels
    (K8 with them: the block selector's DSA chunks; K11's model form: the
    ssm family's scan, and its head-shared form: the hybrid's, both in
    serving too)."""
    from repro_torch.kernels.chunked_ce import kernel as K10
    from repro_torch.kernels.flash_attention import kernel as K9
    from repro_torch.kernels.lightning_indexer import kernel as K7
    from repro_torch.kernels.mamba_scan import kernel as K11
    from repro_torch.kernels.sparse_attention import kernel as K8
    return {"lightning_indexer": (K7, K7.lightning_indexer, K7.reference),
            "flash_attention": (K9, K9.flash_attention, K9.reference),
            "chunked_ce": (K10, K10.chunked_ce, K10.reference),
            "block_sparse_attention": (K8, K8.block_sparse_attention,
                                       K8.block_sparse_attention_plain),
            "mamba_scan_model": (K11, K11.mamba_scan_model,
                                 K11.scan_model),
            "mamba_scan_heads": (K11, K11.mamba_scan_heads,
                                 K11.scan_heads)}


class plain_route:
    """Inside ``with plain_route():`` the model reaches the plain versions of
    K7, K8, K9, K10 and K11 (both of its model forms) on CUDA tensors (each
    wrapper's module attribute is pointed at its plain version, which takes
    the same arguments); the kernels are restored on exit.  Only this
    script's parity phases do this: the port itself has no switch to the
    plain versions on the card."""

    def __enter__(self):
        self._saved = train_kernel_wrappers()
        for name, (mod, _, plain) in self._saved.items():
            setattr(mod, name, plain)
        return self

    def __exit__(self, *exc):
        for name, (mod, wrapper, _) in self._saved.items():
            setattr(mod, name, wrapper)
        return False


def _hold_rel(what, got, want, tol) -> float:
    """|got - want| <= tol * max(1, |want|) for a scalar; returns the abs
    error."""
    err = abs(float(got) - float(want))
    if not err <= tol * max(1.0, abs(float(want))):
        raise AssertionError(f"{what}: {float(got)} vs {float(want)}, abs err "
                             f"{err} > {tol} x max(1, |plain|)")
    return err


def _grads_of(fn, inputs):
    """fn(*inputs) reduced against a fixed random cotangent; returns the
    gradients of the inputs."""
    import torch
    xs = [x.detach().requires_grad_() for x in inputs]
    out = fn(*xs)
    out = out[0] if isinstance(out, tuple) else out
    g = torch.randn(out.shape, generator=torch.Generator(
        device=out.device).manual_seed(SEED + 7), device=out.device)
    return torch.autograd.grad(out, xs, g.to(out.dtype))


def _same_grads(what, fn, inputs) -> None:
    """The gradients through an autograd Function are equal on the kernel
    route and on the plain route: its backward is plain PyTorch and
    recomputes what it needs from the inputs, never from the forward's
    output."""
    import torch
    got = _grads_of(fn, inputs)
    with plain_route():
        want = _grads_of(fn, inputs)
    for i, (a, b) in enumerate(zip(got, want)):
        err = (a.float() - b.float()).abs().max().item()
        if not torch.isfinite(a).all() or err > 0.0:
            raise AssertionError(f"{what}: gradient {i} differs between the "
                                 f"kernel and plain routes by {err}")


def check_train_kernels(device="cuda") -> dict:
    """K7, K9 and K10 against their plain versions at ragged shapes, fp32
    (atol 1e-4) and bf16 (2e-2), scaled by min(1, max|plain|) as K1-K6;
    K10's two sums are held relatively (1e-5 of max(1, |plain|): they sum
    ~1000 token NLLs in another order).  Then the gradients through each
    autograd Function on both routes.  Returns the max error per kernel."""
    import torch
    from repro_torch.kernels.chunked_ce import kernel as K10
    from repro_torch.kernels.flash_attention import kernel as K9
    from repro_torch.kernels.lightning_indexer import kernel as K7
    from repro_torch.kernels.lightning_indexer import ops as li_ops
    from repro_torch.layers.attention import flash_attend
    from repro_torch.models.losses import chunked_softmax_xent
    gen = torch.Generator(device=device).manual_seed(SEED)
    worst = dict.fromkeys(TRAIN_KERNELS, 0.0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        # K9 (fp32: the 3xTF32 tile; bf16: the bf16 tile, at the wrapper's
        # parts and at forced parts 1 and 4): S*G not a multiple of the row
        # tile, Sk ragged, d 64/128/256, causal / window + softcap /
        # q_offset with Sq < Sk / non-causal, each head dim with each
        # option
        cases = [(64, 197, 197, 8, 2, dict()),
                 (128, 200, 200, 32, 4, dict(window=64, softcap=50.0)),
                 (256, 131, 131, 8, 4, dict(window=40, softcap=30.0)),
                 (128, 100, 333, 8, 2, dict(q_offset=233)),
                 (64, 70, 333, 4, 4, dict(causal=False)),
                 (256, 100, 333, 8, 2, dict(q_offset=233, softcap=30.0)),
                 (64, 150, 150, 8, 8, dict(window=32, softcap=20.0)),
                 (64, 90, 301, 6, 2, dict(q_offset=211, window=48)),
                 (128, 333, 333, 4, 1, dict()),
                 (256, 70, 333, 4, 4, dict(causal=False, window=50)),
                 # zamba2's shared block: 32 heads of 80, no GQA
                 (80, 150, 150, 32, 32, dict()),
                 (80, 120, 120, 32, 32, dict(causal=False)),
                 (80, 100, 333, 8, 2, dict(q_offset=233, softcap=30.0)),
                 # phi-3-vision: 32 heads of 96, no GQA
                 (96, 150, 150, 32, 32, dict()),
                 (96, 120, 120, 32, 32, dict(causal=False)),
                 (96, 100, 333, 8, 2, dict(q_offset=233, softcap=30.0)),
                 # whisper-base: 8 heads of 64 over 1500 frames, not
                 # causal: the decoder's text and a decode row against
                 # the frames, the encoder's frames against themselves
                 (64, 448, 1500, 8, 8, dict(causal=False)),
                 (64, 1, 1500, 8, 8, dict(causal=False)),
                 (64, 1500, 1500, 8, 8, dict(causal=False))]
        for d, Sq, Sk, H, KVH, kw in cases:
            q, k, v = rnd(2, Sq, H, d, dtype=dtype), \
                rnd(2, Sk, KVH, d, dtype=dtype), rnd(2, Sk, KVH, d, dtype=dtype)
            want = K9.reference(q, k, v, **kw)
            err = _hold(f"K9 d={d} {kw}", K9.flash_attention(q, k, v, **kw),
                        want, dtype)
            if dtype == torch.bfloat16:
                for parts in (1, 4):
                    err = max(err, _hold(
                        f"K9 d={d} {kw} parts={parts}",
                        K9.launch_flash_attention(q, k, v, parts=parts, **kw),
                        want, dtype))
            worst["flash_attention"] = max(worst["flash_attention"], err)
            _log("kernels", kernel="flash_attention", d=d, Sq=Sq, Sk=Sk, H=H,
                 KVH=KVH, opts=repr(kw), dtype=dn, max_abs_err=err)
        # K7: S not a multiple of the 8-query tile, T of the 128-key tile
        for Hi, Di in ((16, 64), (32, 128), (8, 64), (12, 64), (2, 16)):
            q, w, k = rnd(2, 150, Hi * Di, dtype=dtype), \
                torch.softmax(rnd(2, 150, Hi), -1), rnd(2, 333, Di, dtype=dtype)
            err = _hold(f"K7 {Hi}x{Di}",
                        K7.lightning_indexer(q, w, k, heads=Hi, head_dim=Di),
                        K7.reference(q, w, k, heads=Hi, head_dim=Di), dtype)
            worst["lightning_indexer"] = max(worst["lightning_indexer"], err)
            _log("kernels", kernel="lightning_indexer", heads=Hi,
                 index_dim=Di, S=150, T=333, dtype=dn, body=K7.body(Hi, Di),
                 max_abs_err=err)
        # K10: Tk and V not multiples of the 128 tiles, a partial mask
        for softcap in (0.0, 30.0):
            h, w = rnd(1000, 256, dtype=dtype), rnd(256, 1000, dtype=dtype)
            t = torch.randint(0, 1000, (1000,), generator=gen, device=device,
                              dtype=torch.int32)
            m = (torch.rand(1000, generator=gen, device=device) > 0.3).float()
            got = K10.chunked_ce(h, w, t, m, softcap=softcap)
            want = K10.reference(h, w, t, m, softcap=softcap)
            err = max(_hold_rel(f"K10 loss softcap={softcap} {dn}", got[0],
                                want[0], 1e-5),
                      _hold_rel(f"K10 count {dn}", got[1], want[1], 1e-5))
            worst["chunked_ce"] = max(worst["chunked_ce"], err)
            _log("kernels", kernel="chunked_ce", Tk=1000, D=256, V=1000,
                 softcap=softcap, dtype=dn, max_abs_err=err)
        # K10 at the vocabularies of the rest of the registry, all ragged
        # against the 128-wide vocab tile: phi-3's V 32064 (D 3072),
        # whisper's 51865 (D 512), kimi-k2's 163840 (D 7168; 130 tokens,
        # its (D, V) weight alone is 4.7 GB in fp32); unit-scale logits
        for Tk, D, V in ((300, 3072, 32064), (300, 512, 51865),
                         (130, 7168, 163840)):
            h = rnd(Tk, D, dtype=dtype)
            w = (rnd(D, V) * D ** -0.5).to(dtype)
            t = torch.randint(0, V, (Tk,), generator=gen, device=device,
                              dtype=torch.int32)
            m = (torch.rand(Tk, generator=gen, device=device) > 0.3).float()
            got = K10.chunked_ce(h, w, t, m)
            want = K10.reference(h, w, t, m)
            err = max(_hold_rel(f"K10 V={V} D={D} {dn}", got[0], want[0],
                                1e-5),
                      _hold_rel(f"K10 count V={V} {dn}", got[1], want[1],
                                1e-5))
            worst["chunked_ce"] = max(worst["chunked_ce"], err)
            _log("kernels", kernel="chunked_ce", Tk=Tk, D=D, V=V,
                 softcap=0.0, dtype=dn, max_abs_err=err)
            del h, w
    # gradients through the autograd Functions, fp32, kernel vs plain route
    q, k, v = rnd(2, 300, 8, 128), rnd(2, 300, 2, 128), rnd(2, 300, 2, 128)
    _same_grads("flash_attend", lambda a, b, c: flash_attend(
        a, b, c, window=100, softcap=50.0, q_chunk=128), (q, k, v))
    q, k, v = rnd(2, 200, 32, 80), rnd(2, 200, 32, 80), rnd(2, 200, 32, 80)
    _same_grads("flash_attend d=80", lambda a, b, c: flash_attend(
        a, b, c, q_chunk=128), (q, k, v))
    q, k, v = rnd(2, 200, 32, 96), rnd(2, 200, 32, 96), rnd(2, 200, 32, 96)
    for causal in (True, False):
        _same_grads(f"flash_attend d=96 causal={causal}",
                    lambda a, b, c: flash_attend(a, b, c, causal=causal,
                                                 q_chunk=128), (q, k, v))
    q, k, v = rnd(2, 448, 8, 64), rnd(2, 1500, 8, 64), rnd(2, 1500, 8, 64)
    _same_grads("flash_attend cross 448x1500", lambda a, b, c: flash_attend(
        a, b, c, causal=False, q_chunk=128), (q, k, v))
    for Hi in (16, 8):
        qi, wi, ki = rnd(2, 150, Hi, 64), \
            torch.softmax(rnd(2, 150, Hi), -1), rnd(2, 333, 64)
        _same_grads(f"indexer_scores {Hi}x64", li_ops.indexer_scores,
                    (qi, wi, ki))
    h, W = rnd(2, 500, 256), rnd(256, 1000)
    t = torch.randint(0, 1000, (2, 500), generator=gen, device=device)
    m = torch.ones((2, 500), device=device)
    _same_grads("chunked_softmax_xent", lambda a, b: chunked_softmax_xent(
        a, b, t, m, chunk=128, softcap=30.0), (h, W))
    _log("kernels", autograd="flash_attend (d 128, 80, 96 causal and not, "
         "cross 448 x 1500),indexer_scores (16 and 8 heads),"
         "chunked_softmax_xent", grads="equal on both routes")
    return worst


def time_train_kernels(dense_cfg, dsa_cfg, batch, seq, dsa_seq,
                       device="cuda", reps=10, tag="", causal=True,
                       ce_tokens=None, window=0, softcap=0.0,
                       ce_softcap=0.0) -> dict:
    """Each training kernel at the training runs' shapes in fp32 (TF32 off,
    as the trainer runs): K9 over one dense layer's (B, S, H, d) q and
    (B, S, KVH, d) k/v, causal (not, with ``causal=False``: an encoder's
    self-attention); K10 over one step's tokens (``ce_tokens``, default B
    x S) against the unembedding; K7 (unless ``dsa_cfg`` is None) over one
    256-query chunk of the DSA run against its keys, with the count of
    top-k indices the selector would pick differently from its scores and
    the plain ones (near-ties only).
    Bound: bytes (inputs read once, the output written once) over 3.35 TB/s
    or flops over 67 TFLOP/s (fp32 on the CUDA cores; K9, K10 and K7, which
    run 3xTF32 on the tensor cores, three TF32 products over 494.7), the
    larger.  Library: one scaled_dot_product_attention(is_causal=True)
    over the same q and the KV heads repeated once before the timed loop
    (for K9 only: no single PyTorch call computes K7 or K10).  The
    result's keys, and the lines' kernel names, end in ``tag``.  K9 takes
    a local layer's ``window`` and ``softcap`` (gemma2's; the bound counts
    the keys the window leaves; SDPA takes the window as a boolean mask
    and has no softcap, so it is then timed without it as
    ``sdpa_without_softcap_ms``, not as the library call), K10 the final
    ``ce_softcap``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.lightning_indexer import kernel as K7mod
    wrappers = train_kernel_wrappers()
    gen = torch.Generator(device=device).manual_seed(SEED)
    f32 = torch.float32

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)

    out = {}
    B, S = batch, seq
    H, KVH, d = dense_cfg.num_heads, dense_cfg.num_kv_heads, dense_cfg.head_dim
    q, k, v = rnd(B, S, H, d), rnd(B, S, KVH, d), rnd(B, S, KVH, d)
    _, K9, K9p = wrappers["flash_attention"]
    qs = q.transpose(1, 2).contiguous()
    ks = k.repeat_interleave(H // KVH, 2).transpose(1, 2).contiguous()
    vs = v.repeat_interleave(H // KVH, 2).transpose(1, 2).contiguous()
    kw9 = dict(causal=causal, window=window, softcap=softcap)
    sdpa_kw = dict(is_causal=causal)
    if window:
        pos = torch.arange(S, device=device)
        sdpa_kw = dict(attn_mask=(pos[None] <= pos[:, None])
                       & (pos[:, None] - pos[None] < window))
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, **sdpa_kw), reps)
    # the keys each query sees: all (not causal), causal, or the window's
    pairs = S * S if not causal else sum(min(i + 1, window or S)
                                         for i in range(S))
    out["flash_attention" + tag] = dict(
        ms=cuda_ms(lambda: K9(q, k, v, **kw9), reps),
        device_ms=graph_ms(lambda: K9(q, k, v, **kw9), reps // 2),
        plain_ms=cuda_ms(lambda: K9p(q, k, v, **kw9), 2),
        library_ms=None if softcap else sdpa_ms,
        max_abs_err=_hold("K9 train-shape", K9(q, k, v, **kw9),
                          K9p(q, k, v, **kw9), f32),
        flops=4 * B * H * pairs * d, tf32_products=3,
        bytes=4 * (2 * q.numel() + k.numel() + v.numel()),
        shape=f"B={B} S={S} H={H} KVH={KVH} d={d} "
              f"{'causal' if causal else 'not causal'} window={window} "
              f"softcap={softcap}")
    if softcap:
        _log("timing", kernel="flash_attention" + tag,
             sdpa_without_softcap_ms=sdpa_ms)
    # which kernel the library call runs on these fp32 inputs
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(qs, ks, vs, **sdpa_kw)
        torch.cuda.synchronize()
    _log("timing", kernel="flash_attention" + tag, library_kernels=repr(
        [e.key[:120] for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA]))
    del q, k, v, qs, ks, vs
    out["chunked_ce" + tag] = _k10_train_shape(
        gen, ce_tokens or B * S, dense_cfg.d_model, dense_cfg.vocab_size,
        device, softcap=ce_softcap)
    if dsa_cfg is None:
        _bounds_fp32(out)
        return out
    dsa = dsa_cfg.dsa
    Hi, Di, rows = dsa.index_heads, dsa.index_head_dim, 256
    qi, wi, ki = rnd(1, rows, Hi * Di), torch.softmax(rnd(1, rows, Hi), -1), \
        rnd(1, dsa_seq, Di)
    _, K7, K7p = wrappers["lightning_indexer"]
    kw = dict(heads=Hi, head_dim=Di)
    got, want = K7(qi, wi, ki, **kw), K7p(qi, wi, ki, **kw)
    err = _hold("K7 train-shape", got, want, f32)
    # the selector's top-k sets of the run's last chunk (queries at
    # dsa_seq - rows ..): 3xTF32 sums in another order than plain
    qpos = dsa_seq - rows + torch.arange(rows, device=device)
    near = _topk_boundary("K7 train-shape", got[0], want[0], qpos,
                          dsa.top_k, TOL["float32"]
                          * min(1.0, want.abs().max().item()))
    _log("topk", kernel="lightning_indexer" + tag, k=dsa.top_k,
         near_tie_indices_differing=near)
    del got, want
    out["lightning_indexer" + tag] = dict(
        ms=cuda_ms(lambda: K7(qi, wi, ki, **kw), 50),
        device_ms=graph_ms(lambda: K7(qi, wi, ki, **kw), 50),
        plain_ms=cuda_ms(lambda: K7p(qi, wi, ki, **kw), 10), library_ms=None,
        max_abs_err=err, tf32_products=3, topk_near_ties=near,
        flops=rows * dsa_seq * Hi * (2 * Di + 2),
        bytes=4 * (qi.numel() + wi.numel() + ki.numel() + rows * dsa_seq),
        shape=f"S={rows} T={dsa_seq} Hi={Hi} Di={Di} "
              f"body={K7mod.body(Hi, Di)} (fp32)")
    _bounds_fp32(out)
    return out


def _k10_train_shape(gen, Tk, D, V, device="cuda", softcap=0.0) -> dict:
    """K10 over one training step's Tk tokens against a (D, V) unembedding
    in fp32 (its 3xTF32 tile: bound by three TF32 products), held against
    its plain version (1e-5 of max(1, |plain|)) and timed beside it.
    Unit-scale logits, as the model's (its first loss is ~log V + 0.5): the
    part of the sum that depends on h.W, sum - count * log V, is then
    ~Tk / 2, far above the tolerance, so a kernel that drops or corrupts
    the product fails."""
    import torch
    from repro_torch.kernels.chunked_ce import kernel as K10
    h = torch.randn(Tk, D, generator=gen, device=device)
    w = torch.randn(D, V, generator=gen, device=device) * D ** -0.5
    t = torch.randint(0, V, (Tk,), generator=gen, device=device,
                      dtype=torch.int32)
    m = torch.ones(Tk, device=device)
    kw = dict(softcap=softcap)
    got, want = K10.chunked_ce(h, w, t, m, **kw), \
        K10.reference(h, w, t, m, **kw)
    what = f"K10 train-shape Tk={Tk} D={D} V={V} softcap={softcap}"
    err = _hold_rel(what, got[0], want[0], 1e-5)
    product_part = float(want[0]) - float(want[1]) * math.log(V)
    if not abs(product_part) > 100 * 1e-5 * abs(float(want[0])):
        raise AssertionError(f"{what}: the h.W part of the sum, "
                             f"{product_part}, is not far above the "
                             f"tolerance")
    _log("kernels", kernel="chunked_ce", Tk=Tk, D=D, V=V, softcap=softcap,
         dtype="float32", loss_sum=float(want[0]),
         product_part=product_part, max_abs_err=err)
    return dict(
        ms=cuda_ms(lambda: K10.chunked_ce(h, w, t, m, **kw), 3),
        device_ms=graph_ms(lambda: K10.chunked_ce(h, w, t, m, **kw), 2),
        plain_ms=cuda_ms(lambda: K10.reference(h, w, t, m, **kw), 2),
        library_ms=None, max_abs_err=err,
        flops=2 * Tk * D * V, tf32_products=3,
        bytes=4 * (h.numel() + w.numel() + 2 * Tk),
        shape=f"Tk={Tk} D={D} V={V} softcap={softcap}")


def _bounds_fp32(out: dict) -> None:
    """``_bounds`` for fp32 kernels: bytes over 3.35 TB/s or flops over
    67 TFLOP/s (fp32 on the CUDA cores), the larger; logged with the
    times.  A kernel that runs its fp32 products on the tensor cores as
    ``tf32_products`` TF32 products each (K9: 3xTF32) is bound by those
    over 494.7 TFLOP/s (TF32, dense) instead, which can be the lower: its
    CUDA-core bound is logged beside it as ``bound_ms_fp32_cores``."""
    for name, r in out.items():
        t_bytes = r["bytes"] / H100_BYTES_PER_S * 1e3
        t_cores = r["flops"] / H100_FLOPS["float32"] * 1e3
        t_ops = t_cores
        extra = {}
        if r.get("tf32_products"):
            t_ops = r["tf32_products"] * r["flops"] / H100_FLOPS["tf32"] * 1e3
            extra = dict(bound_ms_fp32_cores=max(t_bytes, t_cores),
                         tf32_products=r["tf32_products"])
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        dev = r.get("device_ms", r["ms"])
        _log("timing", kernel=name, shape=repr(r["shape"]), ms=r["ms"],
             device_ms=r.get("device_ms"), plain_ms=r["plain_ms"],
             library_ms=r["library_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], tflops=r["flops"] / dev / 1e9,
             bound_share=r["bound_ms"] / dev, **extra,
             max_abs_err=r["max_abs_err"], dtype="float32")


def frontend_rows(cfg) -> int:
    """Rows of precomputed embeddings a sequence of ``cfg`` takes, by the
    reference's ``launch/specs.py`` rule: a VLM's ``frontend_tokens``
    patches, which take that many of the sequence's ``seq`` positions; an
    encoder-decoder's ``encoder_seq_len`` frames, beside its text; else
    0."""
    if cfg.family == "vlm":
        return cfg.frontend_tokens
    if cfg.family == "audio":
        return cfg.encoder_seq_len
    return 0


def frontend_embeds(cfg, batch, device, seed=SEED + 4):
    """(batch, frontend_rows(cfg), D) embeddings, 0.01 * N(0, 1) from a
    numpy seed (as ``tests/test_models.py`` makes them), or None."""
    import numpy as np
    import torch
    F = frontend_rows(cfg)
    if not F:
        return None
    rng = np.random.default_rng(seed)
    x = 0.01 * rng.standard_normal((batch, F, cfg.d_model))
    return torch.from_numpy(x.astype(np.float32)).to(device)


def _train_batch(cfg, batch, seq, device):
    """``seq`` positions a sequence: a VLM's patches take the first
    ``frontend_tokens`` of them and its text the rest; an encoder-decoder's
    ``seq`` text tokens come with its frames."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 3)
    text = seq - (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    toks = rng.integers(0, cfg.vocab_size, (batch, text + 1))
    t = torch.from_numpy(toks.astype(np.int32)).to(device)
    out = {"tokens": t[:, :-1], "targets": t[:, 1:]}
    fe = frontend_embeds(cfg, batch, device)
    if fe is not None:
        out["frontend_embeds"] = fe
    return out


class _TopkAlign:
    """DSA's token selection (``core.dsa.select_topk``) in ``train_parity``'s
    two steps.  The kernel route's step records each call's selection; the
    plain route's step, replaying that record, keeps its own selection
    where the two sets agree and takes the recorded one where they differ
    only at near-ties: indices whose plain score lies within the fp32
    tolerance x min(1, max|score|) of the row's k-th score, the K5/K6
    checks' rule (``_topk_boundary``).  The routes' indexer scores differ
    by K7's 3xTF32 rounding and by whatever the kernels upstream changed
    (``gap``: the largest difference, relative to the call's max |plain
    score|), and where that flips a near-tie the routes attend different
    keys: a discrete difference that no kernel tolerance bounds.  A
    difference away from the k-th score raises.  ``near`` counts the
    indices aligned.  With ``on`` False it changes nothing."""

    def __init__(self, on, replay=None):
        self.on, self.replay, self.calls = on, replay, []
        self.near, self.gap = 0, 0.0

    def __enter__(self):
        if self.on:
            from repro_torch.core import dsa
            self._orig = dsa.select_topk
            dsa.select_topk = self._select
        return self

    def __exit__(self, *exc):
        if self.on:
            from repro_torch.core import dsa
            dsa.select_topk = self._orig
        return False

    def _select(self, scores, mask, k, noise=None):
        import torch
        sel, valid = self._orig(scores, mask, k, noise)
        if noise is not None:      # the randomized top-k: the same draw
            scores = scores + noise
        if self.replay is None:
            self.calls.append((sel, valid, scores))
            return sel, valid
        sel_r, valid_r, scores_r = self.replay[len(self.calls)]
        self.calls.append(None)
        live = scores.masked_fill(~mask, 0.0)
        self.gap = max(self.gap, (
            (scores_r.masked_fill(~mask, 0.0) - live).abs().max()
            / live.abs().max().clamp_min(1e-30)).item())

        def chosen(idx, ok):
            out = torch.zeros(scores.shape, dtype=torch.bool,
                              device=scores.device)
            return out.scatter_(-1, idx, ok)
        diff = chosen(sel, valid) ^ chosen(sel_r, valid_r)
        if not bool(diff.any()):
            return sel, valid
        masked = torch.where(mask, scores, float("-inf"))
        kth = masked.topk(min(k, scores.shape[-1]), dim=-1).values[..., -1:]
        tol = TOL["float32"] * min(
            1.0, scores.masked_fill(~mask, 0.0).abs().max().item())
        far = diff & ((scores - kth).abs() > tol)
        if bool(far.any()):
            raise AssertionError(f"train parity: the routes' DSA top-{k} "
                                 f"sets differ at {int(far.sum())} indices "
                                 f"away from the k-th score")
        self.near += int(diff.sum())
        return sel_r, valid_r


def _hold_step(after_k, after_p, grads_k, grads_p, axes, lr,
               failures) -> float:
    """``train_parity``'s bound on the parameters after one optimizer step
    of each route from the same weights: every Muon parameter within 1e-3
    x lr of the plain route's; an AdamW element also within lr x min(2,
    |dg| / 1e-8), dg the routes' gradient gap there (see
    ``train_parity``).  Appends each breach to ``failures``; returns the
    largest parameter difference."""
    import torch
    from repro_torch.optim import muon
    p_err = 0.0
    for k in after_p:
        diff = (after_k[k] - after_p[k]).abs()
        allowed = torch.full_like(diff, 1e-3 * lr)
        if not muon._is_muon_param(axes[k], tuple(diff.shape)):
            dg = (grads_k[k] - grads_p[k]).abs()
            allowed += lr * torch.clamp(dg / 1e-8, max=2.0)
        if bool((diff > allowed).any()):
            failures.append(f"param {k} after the step: "
                            f"{int((diff > allowed).sum())} elements past "
                            f"their bound, max {diff.max().item()}")
        p_err = max(p_err, diff.max().item())
    return p_err


def train_parity(cfg, batch, seq, device="cuda", lr=2e-3,
                 idx_tol=1e-4) -> dict:
    """One train step (loss, gradients, clipping, Muon) on the kernel route
    and one on the plain route, from the same fp32 weights and batch (a
    leaf the loss never reaches has no gradient: it counts as 0, as the
    step counts it; the hybrid's DSA indexer leaves must be such, on both
    routes, since its loss drops the indexer loss).
    Tolerances: the loss within 1e-5 relative; every gradient within 1e-4
    of its leaf's max |plain gradient| (a DSA indexer's within ``idx_tol``:
    with the block selector its only gradient is the mean of
    log_softmax over ~5e6 selected scores, terms near 1/n that almost
    cancel, so the leaf's max is ~1e-7 and a layer whose input moved by
    K8's rounding, ~4e-7 relative, moves it by ~6e-4 of that max; the CPU
    tests hold indexer leaves to 5e-3 for the same reason); after the step
    every Muon
    parameter within 1e-3 * lr of the plain route's.  An AdamW parameter
    at count 1 steps by lr * g / (|g| + eps), eps = 1e-8: a function of g
    bounded by 1 and (1/eps)-Lipschitz, so where the routes' gradients
    differ by dg an element may differ by lr * min(2, |dg| / eps) (a
    gradient within rounding of 0 steps either way); each AdamW element is
    held to that plus 1e-3 * lr.  With DSA's token selector the two steps
    attend the same keys where their top-k sets differ only at near-ties
    (``_TopkAlign``; the count is logged), and nowhere else."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import get_model
    from repro_torch.optim import muon
    M = get_model(cfg)
    model = M.init(cfg, torch.Generator(device=device).manual_seed(SEED),
                   device=device)
    axes = M.param_axes(model)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    data = _train_batch(cfg, batch, seq, device)
    tc = TrainConfig(batch_size=batch, seq_len=seq)

    def one_step():
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(start[k])
        step = make_train_step(model, train_cfg=tc, lr=lr)
        opt = muon.init(dict(model.named_parameters()), axes)
        _, metrics = step(opt, data)
        grads = {k: torch.zeros_like(p) if p.grad is None
                 else p.grad.detach().clone()
                 for k, p in model.named_parameters()}
        after = {k: p.detach().clone() for k, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        return float(metrics["loss"]), grads, after

    align = cfg.dsa is not None and cfg.dsa.selector == "token"
    with _TopkAlign(align) as kernel_topk:
        loss_k, grads_k, after_k = one_step()
    with plain_route(), _TopkAlign(align, kernel_topk.calls) as plain_topk:
        loss_p, grads_p, after_p = one_step()
    if len(plain_topk.calls) != len(kernel_topk.calls):
        raise AssertionError(f"train parity: {len(plain_topk.calls)} top-k "
                             f"selections against "
                             f"{len(kernel_topk.calls)}")
    del kernel_topk
    _hold_rel("train parity loss", loss_k, loss_p, 1e-5)
    if cfg.family == "hybrid" and cfg.dsa is not None:
        idx = [k for k in grads_p if ".idx." in k]
        if not idx or any(g[k].any() for g in (grads_k, grads_p)
                          for k in idx):
            raise AssertionError(f"train parity {cfg.name}: the indexer "
                                 f"leaves {idx} must have no gradient")
    g_err = idx_err = 0.0
    failures = []
    for k in grads_p:
        scale = grads_p[k].abs().max().item()
        e = (grads_k[k] - grads_p[k]).abs().max().item()
        tol = idx_tol if ".idx." in k else 1e-4
        if not e <= tol * scale:
            failures.append(f"grad {k} differs by {e} (max |g| {scale})")
        if ".idx." in k:
            idx_err = max(idx_err, e / max(scale, 1e-30))
        else:
            g_err = max(g_err, e / max(scale, 1e-30))
    p_err = _hold_step(after_k, after_p, grads_k, grads_p, axes, lr,
                       failures)
    if failures:
        raise AssertionError("train parity: " + "; ".join(failures))
    res = dict(loss_kernel=loss_k, loss_plain=loss_p,
               max_rel_grad_err=g_err, max_rel_indexer_grad_err=idx_err,
               max_param_err=p_err, near_tie_indices=plain_topk.near,
               max_rel_score_gap=plain_topk.gap)
    _log("train.parity", model=cfg.name, layers=cfg.num_layers,
         family=cfg.family, dsa=cfg.dsa is not None,
         selector=cfg.dsa.selector if cfg.dsa is not None else None,
         batch=batch, seq=seq, **res)
    del model, start, grads_k, grads_p, after_k, after_p
    return res


def expected_launches(cfg, seq, steps) -> dict:
    """Kernel launches the trainer makes in ``steps`` steps: K10 once a
    step (its backward is plain); for the ssm family K11 once a layer (its
    model form, forward only: the backward recomputes plainly) and no
    other; K9 once an attention layer without DSA (forward
    only: the backward recomputes plainly); K7 twice a DSA layer's query
    chunk (the forward, and the checkpoint's recompute in the backward; a
    DSA layer is a global one: gemma2's local layers keep K9);
    with the block selector K8 twice a chunk too, where the reference's
    rule takes the block branch (chunks of 256 when seq is a multiple of
    256, else one; the chunk and seq multiples of the DSA block).  The
    hybrid's attention layers are its shared block's invocations, one a
    group; its Mamba-2 layers launch K11's head-shared form once each
    (forward only: the chunked backward is plain).  The encoder-decoder
    launches K9 once an encoder layer and twice a decoder layer (its
    self- and cross-attention)."""
    if cfg.family == "ssm":
        return dict(dict.fromkeys(TRAIN_KERNELS, 0), chunked_ce=steps,
                    mamba_scan_model=cfg.num_layers * steps)
    if cfg.family == "audio":     # encoder self, decoder self and cross
        return dict(dict.fromkeys(TRAIN_KERNELS, 0), chunked_ce=steps,
                    flash_attention=(cfg.encoder_layers
                                     + 2 * cfg.num_layers) * steps)
    from repro_torch.models.transformer import layer_kind
    attn_layers, heads = cfg.num_layers, 0
    dsa_layers = sum(layer_kind(cfg, i) == "global"
                     for i in range(cfg.num_layers))
    if cfg.family == "hybrid":
        attn_layers = dsa_layers = cfg.num_layers // cfg.hybrid_attn_every
        heads = cfg.num_layers * steps
    if cfg.dsa is None:
        dsa_layers = 0
    q_chunk = min(cfg.q_chunk, 256)
    chunks = -(-seq // q_chunk)
    k8 = 0
    if cfg.dsa is not None and cfg.dsa.selector == "block":
        step = q_chunk if q_chunk < seq and seq % q_chunk == 0 else seq
        chunks = seq // step
        bs = cfg.dsa.block_size
        if seq >= bs and seq % bs == 0 and step % bs == 0:
            k8 = 2 * dsa_layers * chunks * steps
    return {"chunked_ce": steps,
            "flash_attention": (attn_layers - dsa_layers) * steps,
            "lightning_indexer": 2 * dsa_layers * chunks * steps,
            "block_sparse_attention": k8, "mamba_scan_model": 0,
            "mamba_scan_heads": heads}


def dsa_random(cfg, device="cuda", block_size=16, chunk=64) -> dict:
    """``[dsa.random]``: DSA's randomized top-k (``deterministic_topk=
    False``) through the ContinuousEngine in fp32 on the kernel route (K5 /
    K6 score the pool in place) and on the plain route (``attn_impl=
    "ref"`` under ``plain_route()``: the gathered view, scored by K7's
    plain version, and K5's gather oracle), on the DSA parity prompts,
    with the same scheduling, so both draw the same noise at the same
    shapes: greedy tokens equal wherever the plain route's top-2 margin is
    >= 1e-3.  The deterministic top-k's tokens on the kernel route are
    counted beside them: the tokens the noise moved."""
    import numpy as np
    import torch
    from repro_torch.models import get_model
    from repro_torch.serving import ContinuousEngine, Request
    det = cfg
    cfg = cfg.replace(dsa=dataclasses.replace(cfg.dsa,
                                              deterministic_topk=False))
    model = get_model(cfg).init(
        cfg, torch.Generator(device=device).manual_seed(SEED), device=device,
        dtype=torch.float32)
    rng = np.random.default_rng(SEED + 1)
    prompts, max_new = _long_prompts(rng, cfg.vocab_size)
    max_len = _round_up(max(len(p) for p in prompts) + max(max_new) + chunk,
                        block_size)

    def run(impl):
        eng = ContinuousEngine(model.cfg, model, max_batch=2,
                               block_size=block_size, num_blocks=512,
                               max_len=max_len, prefill_chunk=chunk,
                               attn_impl=impl, device=device)
        reqs = [Request(prompt=p, max_new=m)
                for p, m in zip(prompts, max_new)]
        eng.serve(reqs)
        if any(r.status != "ok" for r in reqs):
            raise AssertionError(f"dsa.random: a request ended "
                                 f"{[r.status for r in reqs]}")
        return [r.out for r in reqs]
    kernels = [k for ks in path_kernels(cfg) for k in ks]
    before = [k.launches for k in kernels]
    kernel = run("kernel")
    if device != "cpu" and not _all_launched(kernels, before):
        raise AssertionError(f"dsa.random: one of "
                             f"{[k.__name__ for k in kernels]} never "
                             f"launched")
    with plain_route():
        plain = run("ref")
        margins = [_margins_ok(model, p, o, device)
                   for p, o in zip(prompts, plain)]
    if not any(margins):
        raise AssertionError("dsa.random: no prompt had a top-2 margin")
    for a, b, ok in zip(kernel, plain, margins):
        if ok and not np.array_equal(a, b):
            raise AssertionError(f"dsa.random: kernel route {a.tolist()} "
                                 f"!= plain route {b.tolist()}")
    model.cfg = det
    try:
        fixed = run("kernel")
    finally:
        model.cfg = cfg
    moved = sum(int((a != b).sum()) for a, b in zip(kernel, fixed))
    res = dict(compared=sum(margins), skipped=len(margins) - sum(margins),
               longest_prompt=max(len(p) for p in prompts),
               top_k=cfg.dsa.top_k, tokens=sum(len(a) for a in kernel),
               tokens_unlike_deterministic=moved)
    _log("dsa.random", model=cfg.name, layers=cfg.num_layers,
         prefill_chunk=chunk, dtype="float32", **res)
    del model
    return res


def train_warmup(cfg, batch, seq, steps=3, device="cuda", lr=2e-3) -> dict:
    """The DSA indexer's warm-up on the card: ``launch.train.train(...,
    freeze="all_but_indexer")`` for ``steps`` steps at full width (fp32,
    TF32 off, lr ``lr`` on the cosine, no warm-up).  Every parameter
    outside the indexers must be bitwise as it was, every indexer
    parameter must have moved, and the indexer KL on the trainer's first
    batch (the loss's ``aux`` / 0.01: the sum over the DSA layers) must be
    lower after the steps than before; the training kernels' launches
    against ``expected_launches`` (the base is frozen, not skipped: the
    forward and its recomputes run as in a full step)."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import lm_generator
    from repro_torch.launch.train import train
    from repro_torch.models import get_model
    M = get_model(cfg)
    model = M.init(cfg, torch.Generator(device=device).manual_seed(SEED),
                   device=device)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    first = {k: torch.from_numpy(v).to(device) for k, v in next(
        lm_generator(cfg.vocab_size, seq, batch, seed=SEED)).items()}

    def kl():
        with torch.no_grad():
            return float(M.loss(model, first)[1]["aux"]) / 0.01
    kl_before = kl()
    wrappers = train_kernel_wrappers()
    for _, fn, _ in wrappers.values():
        fn.launches = 0
    tc = TrainConfig(batch_size=batch, seq_len=seq, learning_rate=lr,
                     warmup_steps=0, total_steps=steps, seed=SEED)
    cuda = device != "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = train(cfg, tc, device=device, log_every=1,
                 freeze="all_but_indexer", model=model)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, (_, fn, _) in wrappers.items()}
    kl_after = kl()
    frozen = moved = 0
    for k, p in model.named_parameters():
        if "idx" in k.split("."):
            moved += int(not torch.equal(p, start[k]))
        elif not torch.equal(p, start[k]):
            raise AssertionError(f"warmup: frozen {k} changed")
        else:
            frozen += 1
    n_idx = len(start) - frozen
    want = expected_launches(cfg, seq, steps)
    res = dict(kl_before=kl_before, kl_after=kl_after,
               kl_a_step=repr([round(h["aux"] / 0.01, 6) for h in hist]),
               losses=repr([round(h["loss"], 5) for h in hist]),
               frozen_leaves=frozen, indexer_leaves=n_idx,
               indexer_leaves_moved=moved, wall_s=wall,
               max_memory_gb=torch.cuda.max_memory_allocated() / 1e9
               if cuda else None, launches=repr(launches))
    _log("train.warmup", model=cfg.name, layers=cfg.num_layers, batch=batch,
         seq=seq, steps=steps, lr=lr, freeze="all_but_indexer", **res)
    if moved != n_idx or not n_idx:
        raise AssertionError(f"warmup: {moved} of {n_idx} indexer leaves "
                             f"moved")
    if not kl_after < kl_before:
        raise AssertionError(f"warmup: the indexer KL {kl_before} -> "
                             f"{kl_after} did not fall")
    if cuda and launches != want:
        raise AssertionError(f"warmup: launches {launches} != expected "
                             f"{want}")
    del model, start
    return dict(res, launches=launches)


def train_run(cfg, batch, seq, steps, device="cuda", lr=2e-3) -> dict:
    """The trainer itself (``launch.train.train``) for ``steps`` steps at
    full width: losses finite and falling, step ms, tokens/s, peak memory,
    and each training kernel's launches against ``expected_launches``."""
    import math
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import train
    wrappers = train_kernel_wrappers()
    tc = TrainConfig(batch_size=batch, seq_len=seq, learning_rate=lr,
                     warmup_steps=0, total_steps=steps, seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    for _, fn, _ in wrappers.values():
        fn.launches = 0                          # counts of the main path
    t0 = time.perf_counter()
    hist = train(cfg, tc, device=device, log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, (_, fn, _) in wrappers.items()}
    want = expected_launches(cfg, seq, steps)
    losses = [h["loss"] for h in hist]
    # the trainer logs tokens/s since its start: per-step wall times follow
    done = [batch * seq * (h["step"] + 1) / h["tok_per_s"] for h in hist]
    step_ms = [1e3 * (b - a) for a, b in zip([0.0] + done, done)]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"train {cfg.name}: losses {losses} not finite "
                             f"and falling")
    if launches != want:
        raise AssertionError(f"train {cfg.name}: launches {launches} != "
                             f"expected {want}")
    if not all(launches[n] > 0 for n, c in want.items() if c):
        raise AssertionError(f"train {cfg.name}: a kernel of the path never "
                             f"launched: {launches}")
    res = dict(losses=[round(x, 5) for x in losses],
               step_ms=[round(x, 1) for x in step_ms],
               tok_per_s=hist[-1]["tok_per_s"],
               steady_tok_per_s=batch * seq * (len(step_ms) - 1)
               / (sum(step_ms[1:]) / 1e3),
               max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches_per_step={n: c / steps for n, c in launches.items()},
               wall_s=wall)
    _log("train", model=cfg.name, layers=cfg.num_layers, family=cfg.family,
         dsa=cfg.dsa is not None,
         selector=cfg.dsa.selector if cfg.dsa is not None else None,
         batch=batch, seq=seq, steps=steps,
         **{k: repr(v) if isinstance(v, (list, dict)) else v
            for k, v in res.items()})
    res["launches"] = launches
    return res



def train_run_frontend(cfg, batch, seq, steps, device="cuda",
                       lr=2e-3) -> dict:
    """``train_run`` for the families whose batches carry precomputed
    embeddings, which the trainer's token corpus does not make (its CLI
    trains a VLM on text alone and refuses an encoder-decoder): the same
    loop (``launch.steps.make_train_step``, Muon, the warm-up cosine
    schedule, the Markov corpus) over ``_train_batch``'s layout, fresh
    embeddings a step.  Checks and logs what ``train_run`` does;
    tokens/s counts the text tokens."""
    import math
    import numpy as np
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import lm_generator
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import get_model
    from repro_torch.optim import muon, schedule
    wrappers = train_kernel_wrappers()
    tc = TrainConfig(batch_size=batch, seq_len=seq, learning_rate=lr,
                     warmup_steps=0, total_steps=steps, seed=SEED)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    for _, fn, _ in wrappers.values():
        fn.launches = 0                          # counts of the main path
    M = get_model(cfg)
    model = M.init(cfg, torch.Generator(device=device).manual_seed(SEED),
                   device=device)
    step_fn = make_train_step(model, train_cfg=tc, lr=lr)
    opt = muon.init(dict(model.named_parameters()), M.param_axes(model))
    text = seq - (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    data = lm_generator(cfg.vocab_size, text, batch, seed=SEED, steps=steps)
    losses, step_ms = [], []
    t_start = time.perf_counter()
    for i, arrays in enumerate(data):
        b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in arrays.items()}
        b["frontend_embeds"] = frontend_embeds(cfg, batch, device,
                                               seed=SEED + 10 + i)
        t0 = time.perf_counter()
        opt, metrics = step_fn(opt, b, lr=schedule.warmup_cosine(
            i, peak=lr, floor=lr * 0.1, warmup=0, total=steps))
        losses.append(float(metrics["loss"]))      # syncs
        step_ms.append(1e3 * (time.perf_counter() - t0))
    wall = time.perf_counter() - t_start
    launches = {name: fn.launches for name, (_, fn, _) in wrappers.items()}
    want = expected_launches(cfg, seq, steps)
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"train {cfg.name}: losses {losses} not finite "
                             f"and falling")
    if device != "cpu" and launches != want:
        raise AssertionError(f"train {cfg.name}: launches {launches} != "
                             f"expected {want}")
    res = dict(losses=[round(x, 5) for x in losses],
               step_ms=[round(x, 1) for x in step_ms],
               steady_tok_per_s=batch * text * (steps - 1)
               / (sum(step_ms[1:]) / 1e3),
               max_memory_gb=torch.cuda.max_memory_allocated() / 1e9
               if device != "cpu" else None,
               launches_per_step={n: c / steps for n, c in launches.items()},
               wall_s=wall, frontend_rows=frontend_rows(cfg),
               text_tokens=text)
    _log("train", model=cfg.name, layers=cfg.num_layers, family=cfg.family,
         encoder_layers=cfg.encoder_layers, dsa=cfg.dsa is not None,
         batch=batch, seq=seq, steps=steps,
         **{k: repr(v) if isinstance(v, (list, dict)) else v
            for k, v in res.items()})
    res["launches"] = launches
    del model, opt, step_fn
    return res


def profile_train_step(cfg, batch, seq, device="cuda", lr=2e-3) -> dict:
    """Where a training step's time goes: one warm step, then one step cut
    into its layers with a synchronise between them (forward through the
    layers, the loss (K10), the backward, clipping + Muon; for the hybrid
    the backward's head-shared scan gradients, ``ref.scan_heads_grads``,
    timed apart with a synchronise around each), then one step under
    torch.profiler: the device's busy share of the step and the device
    time of the top kernels and of K7/K8/K9/K10/K11."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels.mamba_scan import kernel as K11
    from repro_torch.launch.steps import make_train_step
    from repro_torch.layers.common import unembed_matrix
    from repro_torch.models import get_model
    from repro_torch.models.losses import chunked_softmax_xent
    from repro_torch.optim import muon
    M = get_model(cfg)
    model = M.init(cfg, torch.Generator(device=device).manual_seed(SEED),
                   device=device)
    tc = TrainConfig(batch_size=batch, seq_len=seq)
    step = make_train_step(model, train_cfg=tc, lr=lr)
    params = dict(model.named_parameters())
    axes = M.param_axes(model)
    opt = muon.init(params, axes)
    data = _train_batch(cfg, batch, seq, device)
    opt, _ = step(opt, data)                             # warm-up
    torch.cuda.synchronize()
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    for p in params.values():
        p.grad = None
    h, aux, _ = M.hidden(model, data["tokens"])
    mark()
    ce_sum, count = chunked_softmax_xent(
        h, unembed_matrix(model.embed, cfg), data["targets"],
        torch.ones(data["targets"].shape, device=device),
        chunk=cfg.loss_chunk, softcap=cfg.final_logit_softcap)
    total = ce_sum / count + aux
    mark()
    scan_grad_s = []
    grads_fn = K11.scan_heads_grads

    def timed_grads(*a):              # this step only: synchronised apart
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = grads_fn(*a)
        torch.cuda.synchronize()
        scan_grad_s.append(time.perf_counter() - t)
        return out
    K11.scan_heads_grads = timed_grads
    try:
        total.backward()
    finally:
        K11.scan_heads_grads = grads_fn
    mark()
    grads, _ = muon.global_norm_clip(
        {k: torch.zeros_like(p) if p.grad is None else p.grad
         for k, p in params.items()}, tc.grad_clip)
    opt = muon.update(params, grads, axes, opt, lr=lr, cfg=cfg,
                      weight_decay=tc.weight_decay, split=tc.muon_split)
    mark()
    phases = dict(zip(("forward_ms", "loss_ms", "backward_ms", "muon_ms"),
                      (1e3 * (b - a) for a, b in zip(marks, marks[1:]))))
    extra = {}
    if scan_grad_s:
        extra = dict(scan_grad_ms=1e3 * sum(scan_grad_s),
                     scan_grad_calls=len(scan_grad_s),
                     backward_other_ms=phases["backward_ms"]
                     - 1e3 * sum(scan_grad_s))
    wrappers = train_kernel_wrappers()
    before = {n: w.launches for n, (_, w, _) in wrappers.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt, _ = step(opt, data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = {n: w.launches - before[n] for n, (_, w, _) in wrappers.items()}
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)
    busy_us = sum(dev_us(e) for e in kernels)
    # a kernel's instantiations by name: K9 is the 3xTF32 tile on the dense
    # layout in fp32 (the SIMT tile in bf16), K8 the same tile on the
    # selected blocks and its combine pass, K7 the indexer tensor-core body
    # (or, at other head counts, the SIMT tile) on dense keys, K10 two
    # kernels (its fp32 tile the 3xTF32 one), K11 its scan kernel (both
    # passes where time is chunked) or its one-step kernel, its head-shared
    # form at P 64 the chunked route's three kernels (mamba_ssd::)
    ours = {name: sum(dev_us(e) for e in kernels
                      if any(all(k in e.key for k in keys) for keys in alts))
            / 1e3 for name, alts in (
                ("flash_attention", [("tf32_tile", "DenseKV"),
                                     ("gqa_tile_kernel", "DenseKV")]),
                ("chunked_ce", [("ce_tf32", "tile_kernel"),
                                ("ce_tile_kernel",), ("ce_combine_kernel",)]),
                ("lightning_indexer", [("indexer_mma::span_kernel",
                                        "DenseKeys"),
                                       ("indexer_tile_kernel", "DenseKeys")]),
                ("block_sparse_attention", [("tf32_tile", "SelectedBlocks"),
                                            ("combine_kernel",
                                             "SelectedBlocks")]),
                ("mamba_scan", [("mamba::scan_kernel",),
                                ("mamba::step_kernel",)]),
                ("mamba_scan_heads", [("mamba::head_scan_kernel",),
                                      ("mamba::head_step_kernel",),
                                      ("mamba_ssd::",)]))}
    # a kernel the step launched must be found by its name in the trace
    for name, n in launched.items():
        key = "mamba_scan" if name == "mamba_scan_model" else name
        if n and not ours[key] > 0:
            raise AssertionError(f"train.profile: {name} launched {n} times "
                                 f"but no kernel of the trace matches its "
                                 f"names")
    res = dict(phases, **extra, step_ms=sum(phases.values()),
               profiled_step_ms=wall * 1e3,
               device_busy_ms=busy_us / 1e3,
               device_busy_share=busy_us / 1e6 / wall,
               kernel_launches=sum(e.count for e in kernels),
               **{f"{k}_device_ms": v for k, v in ours.items()})
    _log("train.profile", model=cfg.name, layers=cfg.num_layers,
         family=cfg.family, dsa=cfg.dsa is not None,
         selector=cfg.dsa.selector if cfg.dsa is not None else None,
         batch=batch, seq=seq, **res)
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        _log("train.profile.kernel", name=repr(e.key[:60]), calls=e.count,
             device_ms=dev_us(e) / 1e3)
    del model, opt, params, grads
    return res


# ---------------------------------------------------------------------------
# the mesh and analysis layer: the expert-parallel MoE path, remat, the dry
# run against the card
# ---------------------------------------------------------------------------

_CARD = []


def _card() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, printed
    beside every time and memory size of the [mesh] lines."""
    if not _CARD:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        _CARD.append(smi.stdout.strip().splitlines()[0]
                     if smi.returncode == 0 else "nvidia-smi failed")
    return _CARD[0]


def _hold_scaled(what, got, want, dtype) -> float:
    """Finite, and max abs error <= TOL[dtype] * max(1, max|want|): the
    logits' own scale; returns the max abs error."""
    import torch
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[str(dtype).split(".")[1]] * max(
        1.0, want.float().abs().max().item())
    if not torch.isfinite(got).all() or err > tol:
        raise AssertionError(f"{what}: max abs err {err} > {tol} or "
                             f"non-finite")
    return err


class _CountDrops:
    """Inside ``with _CountDrops() as d:`` the EP dispatch records, a call
    at a time, the assignments it dropped (on the device: nothing is read
    back until ``dropped`` is asked for)."""

    def __enter__(self):
        from repro_torch.layers import moe
        self._orig, self.calls = moe._dispatch_local, []

        def counted(idx, gates, T, e_lo, E_local, capacity):
            out = self._orig(idx, gates, T, e_lo, E_local, capacity)
            self.calls.append(((out[2] == E_local * capacity).sum(),
                               idx.numel()))
            return out
        moe._dispatch_local = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.layers import moe
        moe._dispatch_local = self._orig
        return False

    def dropped(self):
        return (sum(int(n) for n, _ in self.calls),
                sum(a for _, a in self.calls))


def mesh_moe(cfg, model, mesh, ample, device="cuda", prefill_len=256,
             rows=8, prompt_len=64, steps=8) -> dict:
    """The expert-parallel MoE path (``moe_impl="expert_parallel"``) through
    ``launch.steps`` on the host mesh, on the served bf16 model: its prefill
    step (1 x ``prefill_len`` tokens) and one serve step (``rows`` rows
    after a ``prompt_len`` prompt) held against the routed path's at
    ``capacity_factor=ample`` (>= E / k: nothing drops) at bf16 2e-2 of the
    logits' scale; two EP runs of each bitwise equal; the dropped
    assignments a step at the default 1.25; the EP serve step under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync); the serve
    step's ms p50 for EP and routed (CUDA events around each of ``steps``
    greedy steps).  Returns the EP prefill's K9 launches."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import kernel as K9
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import get_model
    t_start = time.perf_counter()
    M = get_model(cfg)
    routed = cfg.replace(moe_impl="auto")
    ep_ample = cfg.replace(moe_impl="expert_parallel", capacity_factor=ample)
    ep = cfg.replace(moe_impl="expert_parallel")
    rng = np.random.default_rng(SEED + 11)
    V = cfg.vocab_size
    prefill = make_prefill_step(model, mesh=mesh)
    serve_step = make_serve_step(model, mesh=mesh)
    batch = {"tokens": torch.from_numpy(rng.integers(
        3, V, (1, prefill_len)).astype(np.int32)).to(device)}
    model.cfg = routed
    want = prefill(batch)
    model.cfg = ep_ample
    K9.flash_attention.launches = 0              # counts of the main path
    got = prefill(batch)
    k9 = K9.flash_attention.launches
    if device != "cpu" and k9 != cfg.num_layers:
        raise AssertionError(f"mesh {cfg.name}: the EP prefill step launched "
                             f"K9 {k9} times, not once a layer")
    prefill_err = _hold_scaled(f"mesh {cfg.name} EP prefill vs routed", got,
                               want, torch.bfloat16)
    if not torch.equal(prefill(batch), got):
        raise AssertionError(f"mesh {cfg.name}: two EP prefill steps differ")
    # the serve step from one filled cache, copied for each run
    prompts = torch.from_numpy(rng.integers(
        3, V, (rows, prompt_len)).astype(np.int32)).to(device)
    cache0 = M.init_cache(cfg, rows, prompt_len + steps + 1,
                          dtype=torch.bfloat16, device=device)
    model.cfg = routed
    lg, cache0 = M.prefill(model, prompts, cache0)
    token0 = lg.argmax(-1).to(torch.int32)

    def fresh():
        return {k: {n: t.clone() for n, t in c.items()}
                for k, c in cache0.items()}

    def step(cfg_, cache, token, at):
        model.cfg = cfg_
        return serve_step(token, cache, at)

    want, _ = step(routed, fresh(), token0, prompt_len)
    got, _ = step(ep_ample, fresh(), token0, prompt_len)
    serve_err = _hold_scaled(f"mesh {cfg.name} EP serve step vs routed", got,
                             want, torch.bfloat16)
    first, _ = step(ep, fresh(), token0, prompt_len)
    again, _ = step(ep, fresh(), token0, prompt_len)
    if not torch.equal(first, again):
        raise AssertionError(f"mesh {cfg.name}: two EP serve steps differ")
    cache = fresh()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")      # a host sync raises
    try:
        step(ep, cache, token0, prompt_len)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    timed = {}
    for name, cfg_ in (("ep", ep), ("routed", routed)):
        cache, token, ms = fresh(), token0, []
        with _CountDrops() as drops:
            for i in range(steps):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                lg, cache = step(cfg_, cache, token, prompt_len + i)
                t1.record()
                token = lg.argmax(-1).to(torch.int32)
                torch.cuda.synchronize()
                ms.append(t0.elapsed_time(t1))
        timed[name] = (float(np.median(ms[1:])), drops.dropped())
        if not torch.isfinite(lg).all() or lg.shape != (rows, 1, V):
            raise AssertionError(f"mesh {cfg.name} {name}: logits "
                                 f"{tuple(lg.shape)} not finite")
    model.cfg = cfg
    dropped, assigned = timed["ep"][1]
    res = dict(prefill_max_abs_err=prefill_err, serve_max_abs_err=serve_err,
               ample_capacity_factor=ample, bitwise_equal=True,
               sync_free=True, ep_step_ms_p50=timed["ep"][0],
               routed_step_ms_p50=timed["routed"][0],
               dropped_a_layer_step=dropped / (steps * (cfg.num_layers
                                                    - cfg.first_k_dense)),
               assignments_a_layer_step=assigned / (steps * (cfg.num_layers
                                                      - cfg.first_k_dense)),
               k9_bf16_launches=k9,
               seconds=time.perf_counter() - t_start)
    _log("mesh", model=cfg.name, layers=cfg.num_layers,
         experts=cfg.num_experts, top_k=cfg.experts_per_token,
         dtype="bfloat16", prefill_tokens=prefill_len, rows=rows,
         capacity_factor=ep.capacity_factor, card=repr(_card()), **res)
    res["launches"] = {"flash_attention_bf16": k9}
    return res


def mesh_remat(cfg, batch, seq, device="cuda", reps=3) -> dict:
    """``cfg.remat`` on the training forward: the loss and every gradient
    (fp32, TF32 off) with ``remat="full"`` at ``remat_group`` 1 and 2 held
    against ``"none"`` (loss 1e-5 relative, gradients 1e-4 of each leaf's
    max: ``train_parity``'s bounds); each one's peak memory
    (``max_memory_allocated`` over a forward and backward, the "none"
    gradients resident in all), its forward + backward ms p50 (CUDA events,
    ``reps`` runs) and ``model_flops`` over that time as a share of the
    card's fp32 peak.  K9's and K10's launches of the measured runs."""
    import numpy as np
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.models import get_model
    from repro_torch.roofline import model_flops
    t_start = time.perf_counter()
    M = get_model(cfg)
    model = M.init(cfg, torch.Generator(device=device).manual_seed(SEED),
                   device=device)
    model.requires_grad_(True)
    b = _train_batch(cfg, batch, seq, device)
    wrappers = train_kernel_wrappers()

    def fwd_bwd(cfg_):
        model.cfg = cfg_
        for p in model.parameters():
            p.grad = None
        total, _ = M.loss(model, b)
        total.backward()
        return total.detach()

    base_loss = fwd_bwd(cfg).item()
    base = {k: p.grad for k, p in model.named_parameters()
            if p.grad is not None}
    flops = model_flops(cfg, InputShape("train", seq, batch, "train"))
    out, launches = {}, {}
    for remat, group in (("none", 1), ("full", 1), ("full", 2)):
        c = cfg.replace(remat=remat, remat_group=group)
        for _, fn, _ in wrappers.values():
            fn.launches = 0                       # counts of the main path
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = fwd_bwd(c).item()
        peak = torch.cuda.max_memory_allocated()
        for name, (_, fn, _) in wrappers.items():
            launches[name] = launches.get(name, 0) + fn.launches
        _hold_rel(f"mesh remat {remat} g{group} loss", loss, base_loss, 1e-5)
        worst = 0.0
        for k, g0 in base.items():
            err = (model.get_parameter(k).grad - g0).abs().max().item()
            scale = g0.abs().max().item()
            if not err <= 1e-4 * max(scale, 1e-30):
                raise AssertionError(f"mesh remat {remat} g{group}: grad {k} "
                                     f"err {err} > 1e-4 x {scale}")
            worst = max(worst, err / max(scale, 1e-30))
        ms = []
        for _ in range(reps):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fwd_bwd(c)
            t1.record()
            torch.cuda.synchronize()
            ms.append(t0.elapsed_time(t1))
        step_ms = float(np.median(ms))
        key = "none" if remat == "none" else f"full_g{group}"
        out[key] = dict(loss=loss, grad_rel_err=worst, peak_gb=peak / 1e9,
                        step_ms=step_ms,
                        fp32_peak_share=flops / (step_ms / 1e3)
                        / H100_FLOPS["float32"])
        _log("mesh", model=cfg.name, layers=cfg.num_layers, what="remat",
             remat=remat, remat_group=group, batch=batch, seq=seq,
             dtype="float32", card=repr(_card()), **out[key])
    model.cfg = cfg
    _log("mesh", model=cfg.name, what="remat.summary",
         peak_saved_gb=out["none"]["peak_gb"] - out["full_g1"]["peak_gb"],
         slowdown_g1=out["full_g1"]["step_ms"] / out["none"]["step_ms"],
         slowdown_g2=out["full_g2"]["step_ms"] / out["none"]["step_ms"],
         model_flops=flops, seconds=time.perf_counter() - t_start,
         card=repr(_card()))
    del model, base
    return dict(out, launches=launches)


def mesh_dryrun(cfg, arch, shape_name, layers, batch, device="cuda") -> dict:
    """``launch.dryrun``'s argument bytes for ``arch`` at ``layers`` layers
    and ``shape_name`` at batch ``batch`` (the model, token and cache on
    ``meta``) beside what the card allocates for the same bf16 parameters,
    token and cache (``torch.cuda.memory_allocated`` before and after):
    equal to within the allocator's rounding, 512 bytes a tensor."""
    import torch
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.models import get_model
    from repro_torch.utils import leaves
    t_start = time.perf_counter()
    rec = dryrun.run_one(arch, shape_name, num_layers=layers,
                         global_batch=batch, save=False, verbose=False)
    c = cfg.replace(num_layers=layers)
    M = get_model(c)
    _free()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model = M.init(c, torch.Generator(device=device).manual_seed(SEED),
                   device=device, dtype=torch.bfloat16)
    cache = M.init_cache(c, batch, INPUT_SHAPES[shape_name].seq_len,
                         dtype=torch.bfloat16, device=device)
    token = torch.zeros((batch, 1), dtype=torch.int32, device=device)
    torch.cuda.synchronize()
    card = torch.cuda.memory_allocated() - before
    n = sum(1 for _ in leaves((model, cache, token)))
    diff = card - rec["argument_bytes"]
    if not 0 <= diff <= 512 * n:
        raise AssertionError(f"mesh dryrun {arch}: the card allocated "
                             f"{card} B, the dry run counts "
                             f"{rec['argument_bytes']} B ({n} tensors)")
    res = dict(dryrun_argument_bytes=rec["argument_bytes"],
               card_allocated_bytes=card, tensors=n, diff_bytes=diff,
               dryrun_peak_bytes=rec["peak_memory_bytes"],
               dryrun_dominant=rec["dominant"],
               dryrun_memory_s=rec["memory_s"],
               dryrun_meta_run_s=rec["meta_run_s"],
               seconds=time.perf_counter() - t_start)
    _log("mesh", model=c.name, layers=layers, what="dryrun", shape=shape_name,
         batch=batch, card=repr(_card()), **res)
    del model, cache
    return res


# ---------------------------------------------------------------------------
# the ssm family (falcon-mamba-7b): K11, the static engine, the trainer
# ---------------------------------------------------------------------------

def _scan_inputs(gen, B, S, E, N, dtype, h0_dtype, device):
    """K11's model-form inputs as the layer makes them: dt = softplus(.) > 0
    in the model's dtype, A = -exp(A_log) with the reference's log(1..N)
    init, x / Bc / Cc unit normal, a nonzero h0."""
    import torch
    import torch.nn.functional as F

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)
    dt = F.softplus(rnd(B, S, E) - 1.0).to(dtype)
    A = -torch.arange(1, N + 1, dtype=torch.float32, device=device) \
        .expand(E, N).contiguous()
    x, Bc, Cc = rnd(B, S, E).to(dtype), rnd(B, S, N).to(dtype), \
        rnd(B, S, N).to(dtype)
    h0 = (0.5 * rnd(B, E, N)).to(h0_dtype)
    return dt, A, x, Bc, Cc, h0


def _hold_stored(what, got, want, dtype) -> float:
    """``_hold`` for an output the kernel stores in ``dtype`` (K11's
    contract form): each element may also differ by one unit in the last
    place of its own magnitude (at most 2^-7 of it in bf16, 2^-23 in
    fp32: the dtype's epsilon), where the two versions' fp32 values round
    to neighbouring stored values.  Returns the max abs error."""
    import torch
    name = str(dtype).split(".")[1]
    ulp = torch.finfo(dtype).eps
    diff = (got.float() - want.float()).abs()
    tol = TOL[name] * min(1.0, want.float().abs().max().item())
    bad = diff > tol + ulp * want.float().abs()
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise AssertionError(f"{what} {name}: {int(bad.sum())} elements past "
                             f"{tol} + one stored ulp, max abs err "
                             f"{diff.max().item()}, or non-finite")
    return diff.max().item()


def check_scan_kernels(device="cuda") -> dict:
    """K11 against its plain versions: the model form (``mamba_scan_model``)
    at falcon-mamba's width (E 8192, N 16), the smoke width (E 512, N 8)
    and a ragged E (96, N 16), S 1 (decode), 7, 256 and 1024, dt / x / Bc /
    Cc in fp32 and bf16, h0 nonzero in fp32 and bf16; its y and hT are
    computed and stored in fp32 by both versions from the same inputs, so
    each is held within the fp32 tolerance (1e-4) x min(1, max|plain|)
    whatever the inputs' dtype; the contract form (``mamba_scan``, the
    Pallas kernel's) on the same values discretized, in the same dtype,
    which it also stores its outputs in (fp32 1e-4, bf16 2e-2, scaled, and
    ``_hold_stored``); then the gradients through the autograd
    Function (``mamba1_scan``) on both routes (equal: its backward is plain
    and recomputes from the inputs).  Returns the max error."""
    import torch
    from repro_torch.kernels.mamba_scan import kernel as K11
    from repro_torch.kernels.mamba_scan import ref as R11
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    worst = 0.0
    shapes = ((8, 1, 8192, 16), (2, 7, 8192, 16), (1, 1024, 8192, 16),
              (2, 256, 512, 8), (1, 1024, 512, 8), (3, 7, 96, 16),
              (2, 256, 96, 16))
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for B, S, E, N in shapes:
            for h0_dtype in (torch.float32, torch.bfloat16):
                ins = _scan_inputs(gen, B, S, E, N, dtype, h0_dtype, device)
                got, want = K11.mamba_scan_model(*ins), R11.scan_model(*ins)
                err = max(_hold(f"K11 model y B={B} S={S} E={E} N={N} {dn}",
                                got[0], want[0], torch.float32),
                          _hold(f"K11 model hT B={B} S={S} E={E} N={N} {dn}",
                                got[1], want[1], torch.float32))
                worst = max(worst, err)
                _log("kernels", kernel="mamba_scan_model", B=B, S=S, E=E,
                     N=N, dtype=dn, h0_dtype=str(h0_dtype).split(".")[1],
                     max_abs_err=err)
            dt, A, x, Bc, Cc, h0 = ins
            dA, dBx = (t.to(dtype) for t in R11.discretize(dt, A, x, Bc))
            h0 = h0.to(dtype)
            got, want = K11.mamba_scan(dA, dBx, Cc, h0), \
                R11.reference(dA, dBx, Cc, h0)
            err = max(_hold_stored(f"K11 contract y B={B} S={S} E={E} "
                                   f"N={N}", got[0], want[0], dtype),
                      _hold_stored(f"K11 contract hT B={B} S={S} E={E} "
                                   f"N={N}", got[1], want[1], dtype))
            worst = max(worst, err)
            _log("kernels", kernel="mamba_scan", B=B, S=S, E=E, N=N,
                 dtype=dn, max_abs_err=err)
            del dA, dBx
    for B, S, E, N in ((2, 300, 512, 8), (1, 130, 8192, 16)):
        _same_grads(f"mamba1_scan B={B} S={S} E={E} N={N}", K11.mamba1_scan,
                    _scan_inputs(gen, B, S, E, N, torch.float32,
                                 torch.float32, device))
    _log("kernels", autograd="mamba1_scan", grads="equal on both routes")
    return {"mamba_scan": worst}


# special-function units: 16 results a clock an SM (compute capability
# 9.0), 132 SMs, 1.98 GHz boost: the expf issue rate of an H100 SXM
H100_SFU_PER_S = 16 * 132 * 1.98e9


def time_scan_kernels(cfg, serve_batch, serve_seq, train_batch, train_seq,
                      device="cuda") -> dict:
    """K11's scan kernel's registers, spills, shared memory and CTAs an SM
    (bf16 and fp32, falcon-mamba's N); its model form at the serve prefill
    (bf16), the serve decode step (S 1, bf16 state; also its device time
    from CUDA-graph replay and the wrapper's host microseconds a call) and
    the training shape (fp32), with the time chunks (``parts``) the
    wrapper picks, beside its plain version; the contract form at B 1,
    S 256 (the Pallas kernel's chunk).
    Bound: bytes (dt, x, Bc, Cc, A, h0 read once, y and hT written once)
    over 3.35 TB/s, or operations (8 fp32 operations an element (b, t, e,
    n), the expf counted as one, over 67 TFLOP/s), the larger; the expf's
    issue bound on the special-function units (``H100_SFU_PER_S``, not in
    the guide's table) is logged beside it.  No single PyTorch call
    computes the recurrence, so no library time.  Then K10 at the falcon
    trainer's shape (train_batch x train_seq tokens, d_model, vocabulary
    65024), held against its plain version as at Yi-6B's
    (``_k10_train_shape``), as ``chunked_ce_falcon``."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.build import DTYPE_CODE
    from repro_torch.kernels.mamba_scan import kernel as K11
    from repro_torch.kernels.mamba_scan import ref as R11
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    E, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dn, code in (("bfloat16", 1), ("float32", 0)):
        regs, spill, smem, ctas, per_cta = build.resources(
            "mamba_scan_model_resources", code, code, N)
        _log("resources", kernel="mamba_scan_model", dtype=dn, N=N,
             body="mamba::scan_kernel (a thread a channel)", registers=regs,
             spill_bytes=spill, smem_bytes=smem, ctas_per_sm=ctas,
             channels_per_cta=per_cta, sms=sms)
    out = {}
    for name, B, S, dtype, h0_dtype, reps in (
            ("prefill", serve_batch, serve_seq, torch.bfloat16,
             torch.bfloat16, 20),
            ("decode", serve_batch, 1, torch.bfloat16, torch.bfloat16, 200),
            ("train", train_batch, train_seq, torch.float32, torch.float32,
             20)):
        ins = _scan_inputs(gen, B, S, E, N, dtype, h0_dtype, device)
        dn = str(dtype).split(".")[1]
        got, want = K11.mamba_scan_model(*ins), R11.scan_model(*ins)
        # fp32 outputs from the same inputs on both sides: fp32 tolerance
        err = max(_hold(f"K11 {name}-shape y {dn}", got[0], want[0],
                        torch.float32),
                  _hold(f"K11 {name}-shape hT {dn}", got[1], want[1],
                        torch.float32))
        del got, want
        ms = cuda_ms(lambda: K11.mamba_scan_model(*ins), reps)
        parts = K11.scan_parts(DTYPE_CODE[dtype], DTYPE_CODE[h0_dtype], N, B,
                               S, E, torch.cuda.current_device())
        extra = dict(parts=parts)
        if S == 1:   # host-bound: the device time and the host's share
            extra.update(
                device_ms=graph_ms(lambda: K11.mamba_scan_model(*ins), reps),
                host_us=host_us(lambda: K11.mamba_scan_model(*ins), 100))
        plain_ms = cuda_ms(lambda: R11.scan_model(*ins), 2, warmup=1)
        item, elems = ins[0].element_size(), B * S * E * N
        nbytes = (2 * B * S * E + 2 * B * S * N) * item + E * N * 4 \
            + B * E * N * ins[5].element_size() + (B * S * E + B * E * N) * 4
        ops = 8 * elems + B * S * E
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = ops / H100_FLOPS["float32"] * 1e3
        r = dict(ms=ms, plain_ms=plain_ms, library_ms=None, max_abs_err=err,
                 bytes=nbytes, flops=ops, bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 sfu_bound_ms=elems / H100_SFU_PER_S * 1e3,
                 shape=f"B={B} S={S} E={E} N={N}", **extra)
        out[f"mamba_scan_{name}"] = r
        _log("timing", kernel=f"mamba_scan_model ({name})",
             shape=repr(r["shape"]), ms=ms, plain_ms=plain_ms,
             library_ms=None, bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             sfu_bound_ms=r["sfu_bound_ms"], max_abs_err=err, dtype=dn,
             gb_per_s=nbytes / ms / 1e6, **extra)
        del ins
    B, S = 1, 256
    dt, A, x, Bc, Cc, h0 = _scan_inputs(gen, B, S, E, N, torch.float32,
                                        torch.float32, device)
    dA, dBx = R11.discretize(dt, A, x, Bc)
    ms = cuda_ms(lambda: K11.mamba_scan(dA, dBx, Cc, h0), 20)
    plain_ms = cuda_ms(lambda: R11.reference(dA, dBx, Cc, h0), 2, warmup=1)
    err = _hold("K11 contract chunk", K11.mamba_scan(dA, dBx, Cc, h0)[0],
                R11.reference(dA, dBx, Cc, h0)[0], torch.float32)
    nbytes = 4 * (2 * dA.numel() + B * S * N + 2 * B * E * N + B * S * E)
    _log("timing", kernel="mamba_scan (contract)",
         shape=repr(f"B={B} S={S} E={E} N={N}"), ms=ms, plain_ms=plain_ms,
         library_ms=None, bound_ms=nbytes / H100_BYTES_PER_S * 1e3,
         bound_by="bytes", max_abs_err=err, dtype="float32")
    del dt, A, x, Bc, Cc, h0, dA, dBx
    ce = {"chunked_ce_falcon": _k10_train_shape(
        gen, train_batch * train_seq, cfg.d_model, cfg.vocab_size, device)}
    _bounds_fp32(ce)
    out.update(ce)
    return out


def _head_scan_inputs(gen, B, S, H, P, N, dtype, h0_dtype, device):
    """K11's head-shared inputs as ``apply_mamba2`` makes them: dt =
    softplus(.) in fp32 (B, S, H), A = -exp(A_log) with the reference's
    log(1..H) init, x (B, S, H*P), Bc / Cc unit normal in the model's
    dtype, a nonzero h0 (B, H, P, N)."""
    import torch
    import torch.nn.functional as F

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)
    dt = F.softplus(rnd(B, S, H) - 1.0)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=device)
    x, Bc, Cc = (rnd(*sh).to(dtype) for sh in ((B, S, H * P), (B, S, N),
                                                 (B, S, N)))
    h0 = (0.5 * rnd(B, H, P, N)).to(h0_dtype)
    return dt, A, x, Bc, Cc, h0


def check_head_scan(device="cuda") -> dict:
    """K11's head-shared (Mamba-2) form against its plain version
    (``ref.scan_heads``, the reference's ``_mamba2_scan`` stepped): at
    zamba2's width (H 80 heads of P 64, N 64), at P 64 with N 16 and 32,
    and a ragged one (3 x 40, N 32), S 1 (the decode kernel), 77, 130,
    200 and 1024, x / Bc / Cc in fp32 and bf16, h0 in fp32 and bf16:
    through the wrapper (at P 64 and S > 1 the chunked route on the
    tensor cores), the chunked route forced at 1 and 3 heads a chunk CTA
    (P 64, S 1 included), and the thread-a-channel body at parts 1 and 16
    (at most S).  y is fp32 on both sides: held at the fp32 tolerance x
    min(1, max|plain|); hT is stored in h0's dtype: ``_hold_stored``
    there.  Then the training route, ``mamba2_scan`` (the kernel's
    forward, the chunked plain backward ``ref.scan_heads_grads``) at
    zamba2's width, B 1, S 200 (chunks of 64: a ragged last one), fp32, A
    down to -80, a nonzero h0 and cotangents on y and hT: each input's
    gradient within 1e-4 of its max |gradient| of autograd through the
    stepped ``ref.scan_heads``; one kernel launch.  Returns the max
    error."""
    import torch
    from repro_torch.kernels.mamba_scan import kernel as K11
    from repro_torch.kernels.mamba_scan import ref as R11
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    worst = 0.0
    for B, S, H, P, N in ((8, 1, 80, 64, 64), (1, 1024, 80, 64, 64),
                          (2, 77, 80, 64, 64), (2, 200, 6, 64, 16),
                          (1, 130, 5, 64, 32), (2, 130, 3, 40, 32)):
        for dtype in (torch.float32, torch.bfloat16):
            for h0_dtype in (torch.float32, torch.bfloat16):
                ins = _head_scan_inputs(gen, B, S, H, P, N, dtype, h0_dtype,
                                        device)
                want = R11.scan_heads(*ins)
                runs = [(f"wrapper:{K11.body(S, P, N)}",
                         K11.mamba_scan_heads(*ins))]
                if P == K11.CHUNKED_HEAD_DIM:
                    runs += [(f"ssd:heads={h}",
                              K11.launch_scan_heads_chunked(*ins, h))
                             for h in (1, 3)]
                runs += [(f"head_scan:parts={p}",
                          K11.launch_scan_heads(*ins, p))
                         for p in (1, 16) if p <= S]
                dn = str(dtype).split(".")[1]
                hn = str(h0_dtype).split(".")[1]
                err = 0.0
                for how, got in runs:
                    what = f"K11 heads {how} B={B} S={S} H={H} N={N} {dn}"
                    err = max(err, _hold(what + " y", got[0], want[0],
                                         torch.float32),
                              _hold_stored(what + " hT", got[1], want[1],
                                           h0_dtype)
                              if h0_dtype == torch.bfloat16 else
                              _hold(what + " hT", got[1], want[1],
                                    torch.float32))
                    worst = max(worst, err)
                _log("kernels", kernel="mamba_scan_heads", B=B, S=S, H=H,
                     P=P, N=N, dtype=dn, h0_dtype=hn, max_abs_err=err,
                     runs=",".join(h for h, _ in runs))
    f32 = torch.float32
    ins = _head_scan_inputs(gen, 1, 200, 80, 64, 64, f32, f32, device)
    g_y = torch.randn((1, 200, 80, 64), generator=gen, device=device)
    g_hT = torch.randn((1, 80, 64, 64), generator=gen, device=device)

    def grads(scan):
        xs = [t.detach().requires_grad_() for t in ins]
        y, hT = scan(*xs)
        return torch.autograd.grad([y, hT], xs, [g_y, g_hT])
    before = K11.mamba_scan_heads.launches
    got = grads(K11.mamba2_scan)
    launched = K11.mamba_scan_heads.launches - before
    want = grads(R11.scan_heads)
    if launched != 1:
        raise AssertionError(f"mamba2_scan launched K11 {launched} times")
    rel = {}
    for name, a, b in zip(("dt", "A", "x", "Bc", "Cc", "h0"), got, want):
        scale = b.abs().max().item()
        rel[name] = (a - b).abs().max().item() / max(scale, 1e-30)
        if not (torch.isfinite(a).all() and rel[name] <= 1e-4):
            raise AssertionError(f"mamba2_scan gradient of {name}: "
                                 f"{rel[name]} of its max > 1e-4")
    _log("kernels", kernel="mamba_scan_heads", autograd="mamba2_scan",
         B=1, S=200, H=80, P=64, N=64, backward="ref.scan_heads_grads "
         "(chunked, chunks of 64)", **{f"rel_err_{k}": v
                                        for k, v in rel.items()})
    return {"mamba_scan_heads": worst}


def _head_scan_bound(B, S, H, P, N, item, h_item, route) -> dict:
    """The least time for the head-shared scan on this card at its route's
    precision, the larger of: bytes (dt, x, Bc, Cc, A, h0 read once, y and
    hT written once) over 3.35 TB/s; and, for the chunked route (``ssd``),
    the products its chunks of 64 steps need (a ragged last one counted at
    its length n): G = Cc Bc^T a chunk and (M o G) X a head and chunk over
    their n (n + 1) / 2 lower-triangle entries only (M is 0 above the
    diagonal), the end state (X o m)^T Bc and (e o Cc) h_start^T over all
    n steps; each at the passes the route issues for it: G one bf16 pass
    at 989 TFLOP/s where the inputs are bf16, every other product TF32
    passes at 494.7, two where one operand is bf16 (exact in TF32: x in
    (M o G) X, Bc in the end state), else three.  For the thread-a-channel
    body, 5 fp32 operations an element (b, t, e, n) plus x dt over 67
    TFLOP/s.  The latter, the recurrence's CUDA-core bound, is logged
    beside the chunked route's as ``bound_ms_cuda_cores``."""
    E, L = H * P, 64
    nbytes = 4 * B * S * H + item * (B * S * E + 2 * B * S * N) + 4 * H \
        + 2 * h_item * B * H * P * N + 4 * B * S * E
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_cores = (5 * B * S * E * N + 2 * B * S * E) / H100_FLOPS["float32"] \
        * 1e3
    out = dict(bytes=nbytes, bound_ms_cuda_cores=max(t_bytes, t_cores))
    if route == "ssd":
        tri = (S // L) * L * (L + 1) // 2 + (S % L) * (S % L + 1) // 2
        g_flops = 2 * B * tri * N                    # G, lower triangle
        diag = 2 * B * H * tri * P                   # (M o G) X
        ends = 2 * B * H * S * P * N                 # (X o m)^T Bc
        starts = 2 * B * H * S * P * N               # (e o Cc) h_start^T
        one_bf16 = 2 if item == 2 else 3             # passes, x / Bc bf16
        t_g = g_flops / H100_FLOPS["bfloat16"] if item == 2 \
            else 3 * g_flops / H100_FLOPS["tf32"]
        tf32 = one_bf16 * (diag + ends) + 3 * starts
        t_ops = (t_g + tf32 / H100_FLOPS["tf32"]) * 1e3
        out.update(flops=g_flops + diag + ends + starts,
                   tf32_passes=tf32)
    else:
        t_ops = t_cores
        out.update(flops=5 * B * S * E * N + 2 * B * S * E)
    out.update(bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bound_ms_operations=t_ops)
    return out


def _against_parent(new, old, reps) -> tuple:
    """Device ms of ``new`` and ``old`` from CUDA-graph replays in turns
    (new, old, old, new): the means of each."""
    a = graph_ms(new, reps)
    b = graph_ms(old, reps)
    b = (b + graph_ms(old, reps)) / 2
    a = (a + graph_ms(new, reps)) / 2
    return a, b


def _chunked_breakdown(fn, calls: int = 5) -> dict:
    """Device microseconds a call of each of the chunked route's three
    kernels (torch.profiler over ``calls`` calls of ``fn``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "mamba_ssd::" in e.key:
            us = getattr(e, "self_device_time_total", None) \
                or getattr(e, "self_cuda_time_total", 0.0)
            name = e.key.split("mamba_ssd::")[-1].split("<")[0]
            out[f"{name.replace('_kernel', '')}_us"] = us / max(e.count, 1)
    return out


def _head_scan_resources(dn, code, N, sms) -> None:
    from repro_torch.kernels import build
    regs, spill, smem, ctas, per_cta = build.resources(
        "mamba_scan_heads_resources", code, code, N)
    _log("resources", kernel="mamba_scan_heads", dtype=dn, N=N,
         body="mamba::head_scan_kernel (a thread a channel, one dA a "
         "head; P other than 64, and the parent's body)", registers=regs,
         spill_bytes=spill, smem_bytes=smem, ctas_per_sm=ctas,
         channels_per_cta=per_cta, sms=sms)
    for pass_, name in ((1, "ends_kernel"), (2, "fold_kernel"),
                        (3, "out_kernel")):
        regs, spill, smem, ctas, per_cta = build.resources(
            "mamba_scan_heads_chunked_resources", code, code, N, pass_)
        _log("resources", kernel="mamba_scan_heads", dtype=dn, N=N,
             body=f"mamba_ssd::{name} (chunked, tensor cores)",
             registers=regs, spill_bytes=spill, smem_bytes=smem,
             ctas_per_sm=ctas, per_cta=per_cta, sms=sms)


def time_head_scan(cfg, chunk, batch, device="cuda") -> dict:
    """K11's head-shared form at zamba2's serve shapes: the registers,
    spills, shared memory and CTAs an SM of its kernels (both dtypes, N
    64); a prefill span (B 1, S ``chunk``, bf16 x, bf16 state: the chunked
    route on the tensor cores, 4 chunks x 80 heads) with, in the same
    call, the parent's thread-a-channel body at the time split its wrapper
    picked (``launch_scan_heads``), CUDA-graph device times in turns; and
    a decode step (B ``batch``, S 1, the one-step kernel; with its device
    time and the wrapper's host microseconds a call), beside the plain
    version.  Bound: ``_head_scan_bound``.  No single PyTorch call
    computes the recurrence, so no library time.  The result's
    ``mamba_scan_heads`` is the prefill span's."""
    import torch
    from repro_torch.kernels.mamba_scan import kernel as K11
    from repro_torch.kernels.mamba_scan import ref as R11
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    H = cfg.ssm_expand * cfg.d_model // P
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dn, code in (("bfloat16", 1), ("float32", 0)):
        _head_scan_resources(dn, code, N, sms)
    out = {}
    index = torch.cuda.current_device()
    for name, B, S, reps in (("prefill", 1, chunk, 20),
                             ("decode", batch, 1, 200)):
        dtype = torch.bfloat16
        ins = _head_scan_inputs(gen, B, S, H, P, N, dtype, dtype, device)
        got, want = K11.mamba_scan_heads(*ins), R11.scan_heads(*ins)
        err = max(_hold(f"K11 heads {name}-shape y", got[0], want[0],
                        torch.float32),
                  _hold_stored(f"K11 heads {name}-shape hT", got[1], want[1],
                               dtype))
        del got, want
        route = K11.body(S, P, N)
        ms = cuda_ms(lambda: K11.mamba_scan_heads(*ins), reps)
        parts = K11.scan_parts(1, 1, N, B, S, H * P, index,
                               "mamba_scan_heads_resources")
        extra = dict(route=route)
        if route == "ssd":
            extra["heads_per_cta"] = K11.chunk_heads(1, 1, N, B, S, H, index)
            extra["device_ms"], extra["parent_device_ms"] = _against_parent(
                lambda: K11.mamba_scan_heads(*ins),
                lambda: K11.launch_scan_heads(*ins, parts), reps)
            extra["parent_parts"] = parts
            extra.update(_chunked_breakdown(
                lambda: K11.mamba_scan_heads(*ins)))
        else:
            extra["device_ms"] = graph_ms(lambda: K11.mamba_scan_heads(*ins),
                                          reps)
            extra["host_us"] = host_us(lambda: K11.mamba_scan_heads(*ins),
                                       100)
        plain_ms = cuda_ms(lambda: R11.scan_heads(*ins), 2, warmup=1)
        r = dict(ms=ms, plain_ms=plain_ms, library_ms=None, max_abs_err=err,
                 shape=f"B={B} S={S} H={H} P={P} N={N}",
                 **_head_scan_bound(B, S, H, P, N, 2, 2, route), **extra)
        out[f"mamba_scan_heads_{name}"] = r
        _log("timing", kernel=f"mamba_scan_heads ({name})",
             shape=repr(r["shape"]), ms=ms, plain_ms=plain_ms,
             library_ms=None, bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             bound_ms_cuda_cores=r["bound_ms_cuda_cores"],
             bound_share=r["bound_ms"] / extra["device_ms"],
             max_abs_err=err, dtype="bfloat16",
             gb_per_s=r["bytes"] / extra["device_ms"] / 1e6, **extra)
        del ins
    out["mamba_scan_heads"] = out["mamba_scan_heads_prefill"]
    return out


def time_head_scan_train(cfg, batch, seq, device="cuda", reps=5) -> dict:
    """K11's head-shared form at the hybrid trainer's shape (B ``batch``,
    S ``seq``, zamba2's 80 heads of 64, N 64, fp32 inputs and state, as
    ``apply_mamba2`` trains): the forward kernel (the chunked route; CUDA
    events, and its device time from CUDA-graph replays in turns with the
    parent's thread-a-channel body at its wrapper's time split, then in
    turns with the chunked route at one head a chunk CTA against the
    wrapper's ``chunk_heads``) beside its
    plain stepped version, held against it, and the backward
    ``ref.scan_heads_grads`` with the cotangent the trainer gives (y only:
    hT reaches no loss), its time and the memory it adds.  Bound of the
    forward: ``_head_scan_bound``."""
    import torch
    from repro_torch.kernels.mamba_scan import kernel as K11
    from repro_torch.kernels.mamba_scan import ref as R11
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    H = cfg.ssm_expand * cfg.d_model // P
    B, S, f32 = batch, seq, torch.float32
    index = torch.cuda.current_device()
    ins = _head_scan_inputs(gen, B, S, H, P, N, f32, f32, device)
    g_y = torch.randn((B, S, H, P), generator=gen, device=device)
    got, want = K11.mamba_scan_heads(*ins), R11.scan_heads(*ins)
    err = max(_hold("K11 heads train-shape y", got[0], want[0], f32),
              _hold("K11 heads train-shape hT", got[1], want[1], f32))
    parts = K11.scan_parts(0, 0, N, B, S, H * P, index,
                           "mamba_scan_heads_resources")
    old = K11.launch_scan_heads(*ins, parts)
    err_parent = max(_hold("K11 heads train-shape parent y", old[0], want[0],
                           f32),
                     _hold("K11 heads train-shape parent hT", old[1],
                           want[1], f32))
    del got, want, old
    _free()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    R11.scan_heads_grads(*ins, g_y, None)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    device_ms, parent_ms = _against_parent(
        lambda: K11.mamba_scan_heads(*ins),
        lambda: K11.launch_scan_heads(*ins, parts), reps)
    # the wrapper's heads a chunk CTA against one, in turns
    rule_ms, heads1_ms = _against_parent(
        lambda: K11.mamba_scan_heads(*ins),
        lambda: K11.launch_scan_heads_chunked(*ins, 1), reps)
    split = _chunked_breakdown(lambda: K11.mamba_scan_heads(*ins))
    r = dict(ms=cuda_ms(lambda: K11.mamba_scan_heads(*ins), reps * 4),
             device_ms=device_ms, parent_device_ms=parent_ms,
             parent_parts=parts, parent_max_abs_err=err_parent,
             rule_device_ms=rule_ms, heads1_device_ms=heads1_ms,
             plain_ms=cuda_ms(lambda: R11.scan_heads(*ins), 1, warmup=1),
             backward_ms=cuda_ms(lambda: R11.scan_heads_grads(
                 *ins, g_y, None), reps, warmup=1),
             library_ms=None, max_abs_err=err,
             route=K11.body(S, P, N),
             heads_per_cta=K11.chunk_heads(0, 0, N, B, S, H, index),
             shape=f"B={B} S={S} H={H} P={P} N={N} fp32", **split,
             **_head_scan_bound(B, S, H, P, N, 4, 4, K11.body(S, P, N)))
    _log("timing", kernel="mamba_scan_heads (train)", shape=repr(r["shape"]),
         ms=r["ms"], device_ms=r["device_ms"],
         parent_device_ms=r["parent_device_ms"],
         parent_parts=r["parent_parts"], plain_ms=r["plain_ms"],
         library_ms=None, bound_ms=r["bound_ms"], bound_by=r["bound_by"],
         bound_ms_cuda_cores=r["bound_ms_cuda_cores"],
         bound_share=r["bound_ms"] / r["device_ms"], route=r["route"],
         heads_per_cta=r["heads_per_cta"],
         rule_device_ms=r["rule_device_ms"],
         heads1_device_ms=r["heads1_device_ms"], **split,
         backward_ms=r["backward_ms"],
         backward_over_forward=r["backward_ms"] / r["ms"],
         backward_extra_gb=peak_gb, backward="ref.scan_heads_grads "
         "(chunked, plain)", max_abs_err=err,
         parent_max_abs_err=err_parent, dtype="float32")
    del ins, g_y
    return {"mamba_scan_heads_train": r}


def _ssm_margins_ok(model, prompt, out, plen, device, min_margin=1e-3):
    """Top-2 logit margin of every generated token of a row the static
    engine left-padded to ``plen`` (teacher forcing over the padded row)."""
    import numpy as np
    import torch
    from repro_torch.models import ssm_model
    seq = np.concatenate([np.zeros(plen - len(prompt), np.int64), prompt,
                          out[:-1]]).astype(np.int64)
    with torch.no_grad():
        lg = ssm_model.logits(model, torch.from_numpy(seq)[None].to(device))
    top2 = lg[0, plen - 1:].float().topk(2, dim=-1).values
    return bool(((top2[:, 0] - top2[:, 1]) >= min_margin).all())


def parity_ssm(cfg, device="cuda", max_batch=3) -> dict:
    """falcon-mamba in fp32 through the static ServingEngine (the family's
    engine): greedy tokens on the kernel route equal to the plain route's
    (K11's plain version), wherever the teacher-forced top-2 margin of the
    left-padded row is >= 1e-3, on the short prompt mix in batches of 3
    (left-padding inside each); K11 launched on the kernel route only;
    then prefill + decode logits equal to the full forward's (atol/rtol
    3e-4, as ``tests/test_models.py``'s ssm case)."""
    import numpy as np
    import torch
    from repro_torch.kernels.mamba_scan import kernel as K11
    from repro_torch.models import ssm_model as SM
    from repro_torch.serving import Request, ServingEngine
    model = SM.init(cfg, torch.Generator(device=device).manual_seed(SEED),
                    device=device, dtype=torch.float32)
    rng = np.random.default_rng(SEED + 1)
    prompts, max_new = _short_prompts(rng, cfg.vocab_size, 16)
    outs, launches = {}, {}
    for route in ("kernel", "plain"):
        K11.mamba_scan_model.launches = 0
        eng = ServingEngine(cfg, model, max_batch=max_batch, max_len=256,
                            device=device)
        reqs = [Request(prompt=p, max_new=m) for p, m in zip(prompts, max_new)]
        if route == "kernel":
            eng.serve(reqs)
        else:
            with plain_route():
                eng.serve(reqs)
        outs[route] = [r.out for r in reqs]
        launches[route] = K11.mamba_scan_model.launches
    compared = 0
    with plain_route():
        for i, (p, a, b) in enumerate(zip(prompts, outs["kernel"],
                                          outs["plain"])):
            batch = prompts[i // max_batch * max_batch:
                            (i // max_batch + 1) * max_batch]
            if not _ssm_margins_ok(model, p, b, max(map(len, batch)), device):
                continue
            compared += 1
            if not np.array_equal(a, b):
                raise AssertionError(f"parity (ssm): kernel route "
                                     f"{a.tolist()} != plain {b.tolist()}")
    batches = -(-len(prompts) // max_batch)
    want = cfg.num_layers * (batches + sum(
        max(max_new[i:i + max_batch]) for i in range(0, len(prompts),
                                                     max_batch)))
    if compared == 0 or device != "cpu" and (launches["kernel"] != want
                                             or launches["plain"]):
        raise AssertionError(f"parity (ssm): compared {compared}, K11 "
                             f"launches {launches}, expected {want}")
    # decode = forward (the reference's test_decode_matches_forward_ssm)
    tok = torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, 65))).to(device)
    with torch.no_grad():
        full = SM.logits(model, tok)
    cache = SM.init_cache(cfg, 2, 0, device=device)
    lg, cache = SM.prefill(model, tok[:, :-1], cache)
    lg2, _ = SM.decode_step(model, tok[:, -1:], cache, 64)
    dec_err = 0.0
    for what, a, b in (("prefill", lg[:, 0], full[:, -2]),
                       ("decode", lg2[:, 0], full[:, -1])):
        err = (a - b).abs().max().item()
        if not err <= 3e-4 * (1 + b.abs().max().item()):
            raise AssertionError(f"parity (ssm): {what} logits differ from "
                                 f"the forward's by {err}")
        dec_err = max(dec_err, err)
    res = dict(compared=compared, skipped=len(prompts) - compared,
               k11_launches=launches["kernel"],
               decode_vs_forward_max_abs_err=dec_err)
    _log("parity", model=cfg.name, layers=cfg.num_layers, family=cfg.family,
         engine="ServingEngine", dtype="float32", oracle="plain route",
         **res)
    del model
    return res


class _TimedModel:
    """The static engine's model module with each call it makes timed by
    the script (the engine stamps no times): a synchronise before and after
    ``prefill`` and every ``decode_step``."""

    def __init__(self, module):
        self._m = module
        self.prefill_ms, self.decode_ms = [], []

    def __getattr__(self, name):
        return getattr(self._m, name)

    def _timed(self, fn, into, *a, **kw):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        into.append(1e3 * (time.perf_counter() - t0))
        return out

    def prefill(self, *a, **kw):
        return self._timed(self._m.prefill, self.prefill_ms, *a, **kw)

    def decode_step(self, *a, **kw):
        return self._timed(self._m.decode_step, self.decode_ms, *a, **kw)


def serve_ssm(cfg, prompt_lens, device="cuda", max_new=32) -> dict:
    """falcon-mamba at full width and depth in bf16 through the static
    ServingEngine: one batch of the prompts (left-padded to the longest),
    after a warm-up batch: prefill ms (the batch's TTFT), decode step ms
    (p50), decode tok/s (B x max_new over the decode steps' time), K11's
    launches (one a layer for the prefill and for each of the max_new
    decode steps) and K10's (none: serving computes logits, no loss).  The
    result carries the model under ``"model"``."""
    import numpy as np
    import torch
    from repro_torch.kernels.chunked_ce import kernel as K10
    from repro_torch.kernels.mamba_scan import kernel as K11
    from repro_torch.models import ssm_model as SM
    from repro_torch.serving import Request, ServingEngine
    t0 = time.perf_counter()
    model = SM.init(cfg, torch.Generator(device=device).manual_seed(SEED),
                    device=device, dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    eng = ServingEngine(cfg, model, max_batch=len(prompt_lens),
                        max_len=max(prompt_lens) + max_new, device=device)
    rng = np.random.default_rng(SEED + 2)
    V = cfg.vocab_size
    prompts = [rng.integers(3, V, size=n).astype(np.int32)
               for n in prompt_lens]
    eng.serve([Request(prompt=p[:16], max_new=2) for p in prompts])  # warm-up
    setup_s = time.perf_counter() - t0
    timed = eng.model = _TimedModel(SM)
    reqs = [Request(prompt=p, max_new=max_new) for p in prompts]
    K11.mamba_scan_model.launches = K11.mamba_scan.launches = 0
    K10.chunked_ce.launches = 0                  # counts of the main path
    t0 = time.perf_counter()
    eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mamba_scan_model": K11.mamba_scan_model.launches,
                "mamba_scan": K11.mamba_scan.launches,
                "chunked_ce": K10.chunked_ce.launches}
    for r in reqs:
        if r.out is None or len(r.out) != max_new \
                or not ((r.out >= 0) & (r.out < V)).all():
            raise AssertionError(f"serve (ssm): bad output {r.out}")
    want = cfg.num_layers * (1 + max_new)
    if device != "cpu" and launches["mamba_scan_model"] != want:
        raise AssertionError(f"serve (ssm): K11 launched "
                             f"{launches['mamba_scan_model']} times, want "
                             f"{want}")
    decode_s = sum(timed.decode_ms) / 1e3
    res = dict(params_b=n_params / 1e9, batch=len(reqs),
               prompt_tokens=int(sum(prompt_lens)),
               padded_prompt=max(prompt_lens), new_tokens=max_new,
               prefill_ms=timed.prefill_ms[0],
               decode_step_p50_ms=float(np.median(timed.decode_ms)),
               decode_steps=len(timed.decode_ms),
               decode_tok_s=len(reqs) * max_new / decode_s,
               wall_s=wall, setup_s=setup_s,
               state_mb_per_request=2 * cfg.num_layers * (
                   (cfg.ssm_conv - 1) + cfg.ssm_state)
               * cfg.ssm_expand * cfg.d_model / 1e6,
               mamba_scan_launches=launches["mamba_scan_model"],
               chunked_ce_launches=launches["chunked_ce"])
    _log("serve", model=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         family=cfg.family, engine="ServingEngine", dtype="bfloat16", **res)
    res["launches"] = launches
    res["model"] = model
    return res


def profile_ssm_decode(cfg, model, device="cuda", batch=8, prompt_len=512,
                       steps=8) -> dict:
    """``steps`` decode steps of the static engine's call
    (``ssm_model.decode_step``) on ``batch`` rows after a ``prompt_len``
    prefill, timed and then traced with torch.profiler: device busy share,
    launches a step, top kernels and K11's device time a call."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import ssm_model as SM
    rng = np.random.default_rng(SEED + 3)
    tok = torch.from_numpy(rng.integers(3, cfg.vocab_size,
                                        (batch, prompt_len))).to(device)
    cache = SM.init_cache(cfg, batch, 0, dtype=torch.bfloat16, device=device)
    lg, cache = SM.prefill(model, tok, cache)
    nxt = lg.argmax(-1)
    for _ in range(2):                                  # warm
        lg, cache = SM.decode_step(model, nxt, cache)
        nxt = lg.argmax(-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        lg, cache = SM.decode_step(model, nxt, cache)
        nxt = lg.argmax(-1)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            lg, cache = SM.decode_step(model, nxt, cache)
            nxt = lg.argmax(-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)
    busy_us = sum(dev_us(e) for e in kernels)
    k11 = [e for e in kernels if "mamba::step_kernel" in e.key]
    k11_calls = sum(e.count for e in k11)
    res = dict(step_ms=plain_wall / steps * 1e3,
               profiled_step_ms=wall / steps * 1e3,
               device_busy_ms_per_step=busy_us / steps / 1e3,
               device_busy_share=busy_us / 1e6 / wall,
               kernel_launches_per_step=sum(e.count for e in kernels) / steps,
               mamba_scan_calls_per_step=k11_calls / steps,
               mamba_scan_device_ms_per_call=sum(dev_us(e) for e in k11)
               / max(k11_calls, 1) / 1e3)
    _log("profile", model=cfg.name, layers=cfg.num_layers, family=cfg.family,
         batch=batch, prompt_len=prompt_len, **res)
    for e in sorted(kernels, key=dev_us, reverse=True)[:8]:
        _log("profile.kernel", name=repr(e.key[:60]),
             device_ms_per_step=dev_us(e) / steps / 1e3,
             calls_per_step=e.count / steps,
             device_ms_per_call=dev_us(e) / max(e.count, 1) / 1e3)
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import get_model

    _log("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=repr(torch.cuda.get_device_name(0)),
         count=torch.cuda.device_count())
    t0 = t_start = time.perf_counter()

    def stamp(phase):     # seconds since the start, at each phase's end
        _log("time", after=phase, seconds=time.perf_counter() - t_start)
    libs = build.build_all(build.LIBRARIES)   # one nvcc a source, in parallel
    for name in build.LIBRARIES:
        build.load(name)
    _log("build", seconds=time.perf_counter() - t0,
         libraries=",".join(p.name for p in libs))
    # the host mesh (a process group of one rank): the [mesh] phase's steps
    # run on it, and the trainers reuse it
    from repro_torch.launch.mesh import destroy_host_mesh, make_host_mesh
    mesh = make_host_mesh()

    worst = check_kernels()
    worst.update(check_mla_kernels())
    worst.update(check_indexer_kernels())
    worst.update(check_train_kernels())
    worst.update(check_sparse_kernels())
    worst.update(check_scan_kernels())
    worst.update(check_head_scan())
    stamp("kernels")
    prompt_lens = [1024, 32, 777, 150, 512, 64, 900, 300]
    serve_lens = [n + 16 for n in prompt_lens]
    # the DSA mix: two prompts past 3 x top-k, four past top-k
    dsa_lens = [6144, 32, 3000, 150, 4096, 64, 2500, 300]
    yi_dsa = get_config("yi_6b")          # its own DSAConfig: 16 x 64, 2048
    yi = yi_dsa.replace(dsa=None)
    # the DSA block selector: the same indexer, top 16 blocks of 128
    yi_block = yi_dsa.replace(dsa=dataclasses.replace(yi_dsa.dsa,
                                                      selector="block"))
    # GLM-5 at full width, depth cut 78 -> 4 (3 dense-MLP + 1 MoE layer),
    # and its MTP layer (one dense-MLP MLA block, shared by 3 steps)
    glm5_mtp = get_config("glm5_744b").replace(num_layers=4)
    glm5 = glm5_mtp.replace(mtp=None)
    # zamba2-2.7b at full width and depth (54 Mamba-2 layers, the shared
    # block 9 times): as published (dense attention at head dim 80) and
    # with the repo's DSA retrofit on the shared block (8 x 64 indexer)
    zamba2_dsa = get_config("zamba2_2p7b")
    zamba2 = zamba2_dsa.replace(dsa=None)
    z_groups = zamba2.num_layers // zamba2.hybrid_attn_every
    # the rest of the registry (slice 19), each as its published model
    # runs, without the repo's DSA retrofit: phi-3-vision (family vlm, 32
    # heads of 96, 576 patch embeddings), qwen3-moe (G 16, qk_norm, 128
    # experts), kimi-k2 (G 8, a dense first layer, 384 experts + a shared
    # one), nemotron-4 (G 6, relu2), minitron (G 3, relu2); whisper-base
    # (family audio: 6 + 6 layers over 1500 frames, no DSA)
    # gemma2-2b (slice 21) at published width and depth: 26 layers
    # alternating local (window 4096) and global, softcaps 50 / 30, vocab
    # 256000 tied; as published and with the repo's DSA retrofit on its 13
    # global layers (8 x 64 indexer, top-k 2048)
    gemma2_dsa = get_config("gemma2_2b")
    gemma2 = gemma2_dsa.replace(dsa=None)
    g_window, g_softcap = gemma2.sliding_window, gemma2.attn_logit_softcap
    phi3 = get_config("phi3_vision_4b").replace(dsa=None)
    qwen3 = get_config("qwen3_moe_235b").replace(dsa=None)
    kimi = get_config("kimi_k2_1t").replace(dsa=None)
    nemotron = get_config("nemotron4_15b").replace(dsa=None)
    minitron = get_config("minitron_4b").replace(dsa=None)
    whisper = get_config("whisper_base")
    whisper_text = 448           # Whisper's text context (arXiv:2212.04356)
    chunk, new_tokens = 256, 32
    decode_mb = (max(serve_lens + prompt_lens) + chunk) // 16 + 1
    mla_resources(glm5, len(prompt_lens), decode_mb)
    dsa_max_len = max(dsa_lens) + new_tokens + chunk
    indexer_resources(yi_dsa, len(dsa_lens), dsa_max_len, 16)
    tile_resources(yi, yi_block, chunk, glm5, len(prompt_lens), 3,
                   yi.replace(num_layers=8), decode_mb)
    timing = time_kernels(yi, serve_lens, max(prompt_lens), bs=16,
                          num_blocks=2048, chunk=chunk)
    _free()
    timing.update(time_mla_kernels(glm5, serve_lens, max(prompt_lens),
                                   bs=16, num_blocks=2048, chunk=chunk))
    _free()
    span_start = (max(dsa_lens) - 1) // chunk * chunk
    timing.update(time_indexer_kernels(
        yi_dsa, [n + 16 for n in dsa_lens], span_start,
        max(dsa_lens) - span_start, bs=16, num_blocks=2048,
        mb=dsa_max_len // 16))
    _free()
    # zamba2's shared block: K1/K2 at head dim 80 (32 heads, G 1) and K5/K6
    # at 8 x 64 indexer heads over its 9 invocations' pools; K11's
    # head-shared form at its prefill span and decode step
    timing.update(time_kernels(zamba2.replace(num_layers=z_groups),
                               serve_lens, max(prompt_lens), bs=16,
                               num_blocks=2048, chunk=chunk, tag="_zamba2"))
    _free()
    timing.update(time_indexer_kernels(
        zamba2_dsa.replace(num_layers=z_groups), [n + 16 for n in dsa_lens],
        span_start, max(dsa_lens) - span_start, bs=16, num_blocks=2048,
        mb=dsa_max_len // 16, tag="_zamba2"))
    _free()
    timing.update(time_head_scan(zamba2, chunk, len(prompt_lens)))
    _free()
    # gemma2's serve shapes on the DSA mix (its long rows pass the window):
    # K1/K2 at 4 KV heads x G 2 x d 256 with the local layers' window 4096
    # and softcap 50 over its 13 local layers' pools; K5/K6 at 8 x 64 over
    # its 13 global layers'
    timing.update(time_kernels(gemma2.replace(num_layers=13),
                               [n + 16 for n in dsa_lens], max(dsa_lens),
                               bs=16, num_blocks=2048, chunk=chunk,
                               tag="_gemma2", window=g_window,
                               softcap=g_softcap))
    _free()
    timing.update(time_indexer_kernels(
        gemma2_dsa.replace(num_layers=13), [n + 16 for n in dsa_lens],
        span_start, max(dsa_lens) - span_start, bs=16, num_blocks=2048,
        mb=dsa_max_len // 16, tag="_gemma2"))
    _free()
    # the training path: Yi-6B at full width, depth cut to 8 layers so that
    # fp32 weights, gradients and Muon state fit beside the activations
    yi_train, yi_dsa_train = yi.replace(num_layers=8), \
        yi_dsa.replace(num_layers=8)
    train_shapes = dict(batch=2, seq=2048, dsa_seq=4096)
    timing.update(time_train_kernels(yi_train, yi_dsa_train, **train_shapes))
    _free()
    # zamba2's training shapes: K9 at 32 heads of 80, K10 at D 2560 / V
    # 32000, K7 at 8 x 64; K11's head-shared form and its chunked backward
    # at the trainer's 2 x 2048.  Training cuts its depth 54 -> 12: two
    # shared-block invocations, whose gradients sum
    z_train, z_dsa_train = zamba2.replace(num_layers=12), \
        zamba2_dsa.replace(num_layers=12)
    timing.update(time_train_kernels(z_train, z_dsa_train, **train_shapes,
                                     tag="_zamba2"))
    _free()
    timing.update(time_head_scan_train(zamba2, batch=2, seq=2048))
    _free()
    # gemma2's training shapes (1 x 8192: the local layers' window binds):
    # K9 at 8 / 4 heads of 256 with window 4096 and softcap 50, K10 at D
    # 2304 / V 256000 with the final softcap 30, K7 at 8 x 64 over T 8192
    g_train, g_dsa_train = gemma2.replace(num_layers=4), \
        gemma2_dsa.replace(num_layers=4)
    timing.update(time_train_kernels(
        g_train, g_dsa_train, batch=1, seq=8192, dsa_seq=8192,
        tag="_gemma2", window=g_window, softcap=g_softcap,
        ce_softcap=gemma2.final_logit_softcap))
    _free()
    stamp("timing.zamba2_train")
    # K9's bf16 route at the RL loop backend's re-forward (232 + 8 tokens)
    timing.update(time_k9_loop(yi, prompt_pad=232, loop_new=8))
    _free()
    # K8: a 256-token span ending at 6144 over the block serve's view, and
    # the training run's last chunk
    block_view = _round_up(dsa_max_len, yi_block.dsa.block_size)
    timing.update(time_sparse_kernels(yi_block, max(dsa_lens), block_view,
                                      train_shapes["dsa_seq"]))
    timing.update(time_k7_span(yi_block, max(dsa_lens), block_view))
    _free()
    # falcon-mamba-7b: full width (d_model 4096, E 8192, N 16) and depth (64
    # layers) for serving in bf16; depth cut to 8 layers for fp32 training
    falcon = get_config("falcon_mamba_7b")
    falcon_train = falcon.replace(num_layers=8)
    timing.update(time_scan_kernels(falcon, serve_batch=len(prompt_lens),
                                    serve_seq=max(prompt_lens),
                                    train_batch=2, train_seq=2048))
    timing["mamba_scan"] = timing["mamba_scan_prefill"]
    # K10 on both trainers' shapes: the line's error is the worse of the two
    worst["chunked_ce"] = max(worst["chunked_ce"],
                              timing["chunked_ce_falcon"]["max_abs_err"])
    _free()
    # K1/K2 at phi-3-vision's 32 heads of 96 (G 1) and qwen3-moe's G 16,
    # over 8 layers' pools; K9/K10 at phi-3's training shape (B 1, 2048
    # rows: 576 patches + 1472 text tokens) and whisper's (K9 at the
    # encoder's 1500 frames, not causal, B 8; K10 over 8 x 448 tokens)
    for cfg_, tag_ in ((phi3, "_phi3"), (qwen3, "_qwen3")):
        timing.update(time_kernels(cfg_.replace(num_layers=8), serve_lens,
                                   max(prompt_lens), bs=16, num_blocks=2048,
                                   chunk=chunk, tag=tag_))
        _free()
    timing.update(time_train_kernels(
        phi3, None, batch=1, seq=2048, dsa_seq=0,
        ce_tokens=2048 - phi3.frontend_tokens, tag="_phi3"))
    _free()
    timing.update(time_train_kernels(
        whisper, None, batch=8, seq=whisper.encoder_seq_len, dsa_seq=0,
        causal=False, ce_tokens=8 * whisper_text, tag="_whisper"))
    _free()
    stamp("timing")
    parity(yi.replace(num_layers=2))
    _free()
    parity(yi_dsa.replace(num_layers=2), long=True)
    _free()
    parity(glm5.replace(num_layers=2, first_k_dense=1))   # ~49 GB in fp32
    _free()
    parity_block(yi_block.replace(num_layers=2))
    _free()
    parity_mtp(glm5_mtp.replace(num_layers=2, first_k_dense=1))   # ~51 GB
    _free()
    parity_ssm(falcon.replace(num_layers=2))
    _free()
    # zamba2 at depth 12 (two shared-block invocations: the second reads
    # the pool at table + stride), fp32, whole-prompt and chunked prefill
    for cfg_, long_ in ((zamba2, False), (zamba2_dsa, True)):
        parity(cfg_.replace(num_layers=12), chunks=(None, 64), long=long_)
        _free()
    # gemma2 at 2 layers (one local, one global), fp32, both variants, on
    # the long prompts with one of 4600 tokens: past the window and top-k
    for cfg_ in (gemma2, gemma2_dsa):
        parity(cfg_.replace(num_layers=2), long=True,
               long_lens=(2600, 4600), logprobs=True)
        _free()
    # its final softcap saturates on random weights (no top-2 margin of
    # 1e-3 above): the same weights without it give the token rule margins
    parity(gemma2_dsa.replace(num_layers=2, final_logit_softcap=0.0),
           long=True, long_lens=(2600, 4600))
    _free()
    # DSA's randomized top-k: kernel route against plain route (Yi-6B +
    # DSA, 2 layers, fp32)
    dsa_random(yi_dsa.replace(num_layers=2))
    _free()
    # the serving layers around the engine (front-end, spill, disagg) at
    # Yi-6B width, 2 layers, fp32
    frontend_parity(yi.replace(num_layers=2))
    _free()
    # the rest of the registry at full width, fp32: phi-3-vision at 2
    # layers (its prefill step over 576 patches, then text-only engine
    # parity), whisper-base whole, qwen3-moe (1 MoE layer of 128 experts a
    # layer, ~25 GB) and nemotron-4 at 2 layers; kimi-k2 at 2 dense layers
    # (first_k_dense=2: one of its MoE layers alone is ~68 GB in fp32; its
    # MoE path is the one GLM-5's parity holds)
    parity_prefill_step(phi3.replace(num_layers=2))
    _free()
    parity(phi3.replace(num_layers=2))
    _free()
    parity_encdec(whisper)
    _free()
    for cfg_ in (qwen3.replace(num_layers=2), nemotron.replace(num_layers=2),
                 kimi.replace(num_layers=2, first_k_dense=2)):
        parity(cfg_)
        _free()
    stamp("parity")
    # the main paths' launches: every serve and train run below, summed
    launches = collections.Counter()
    yi_serve = serve(yi, prompt_lens)
    launches.update(yi_serve["launches"])
    stamp("serve.yi")
    # the same mix through the front-end, a push, a crash, the spill tier
    # and the disaggregated server, on the same bf16 model
    launches.update(frontend_serve(yi, prompt_lens, yi_serve.pop("model"),
                                   yi_serve)["launches"])
    del yi_serve
    _free()
    stamp("frontend")
    # asynchronous agent RL: the captured logprobs against the trainer's
    # (2 layers, fp32), then the loop at Yi-6B's width, depth 32 -> 4
    rl_parity(yi.replace(num_layers=2))
    _free()
    # the same on Yi-6B + DSA with top-k cut to 32 (the rows' 48-80 keys
    # pass it): deterministic top-k held as the dense run; randomized
    # top-k's gaps recorded (GLM-5 §3.2), not held
    yi_rl_dsa = yi_dsa.replace(num_layers=2, dsa=dataclasses.replace(
        yi_dsa.dsa, top_k=32))
    rl_parity(yi_rl_dsa)
    _free()
    rl_parity(yi_rl_dsa.replace(dsa=dataclasses.replace(
        yi_rl_dsa.dsa, deterministic_topk=False)), gate=False)
    _free()
    launches.update(rl_run(yi.replace(num_layers=4))["launches"])
    _free()
    stamp("rl")
    # Yi-6B + DSA and + DSA(block) at 16 layers, cut for time (~20 s each
    # at full depth)
    launches.update(serve(yi_dsa.replace(num_layers=16), dsa_lens,
                          max_new=new_tokens)["launches"])
    _free()
    launches.update(serve(yi_block.replace(num_layers=16), dsa_lens,
                          max_new=new_tokens)["launches"])
    _free()
    glm5_off = serve(glm5_mtp, prompt_lens)
    launches.update(glm5_off["launches"])
    _free()
    glm5_on = serve(glm5_mtp, prompt_lens, spec_steps=3,
                    model=glm5_off.pop("model"))
    launches.update(glm5_on["launches"])
    _log("serve.mtp", model=glm5_mtp.name, spec_steps=3,
         tpot_p50_ms=glm5_on["tpot_p50_ms"],
         tpot_p50_ms_spec_off=glm5_off["tpot_p50_ms"],
         ttft_p50_ms=glm5_on["ttft_p50_ms"],
         ttft_p50_ms_spec_off=glm5_off["ttft_p50_ms"],
         decode_tok_s=glm5_on["decode_tok_s"],
         decode_tok_s_spec_off=glm5_off["decode_tok_s"],
         accept_length=glm5_on["accept_length"],
         spec_rounds=glm5_on["spec_rounds"])
    # the same model, greedy, with true logprobs: spec 3 against spec off
    # (printed: its MoE layer's router near-ties part the runs in bf16),
    # then the same widths with every layer dense, held at 2e-2
    mtp_logprobs(glm5_mtp, glm5_on["model"], prompt_lens, gate=False)
    del glm5_on, glm5_off
    _free()
    glm5_dense = glm5_mtp.replace(first_k_dense=glm5_mtp.num_layers)
    mtp_logprobs(glm5_dense, get_model(glm5_dense).init(
        glm5_dense, torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda", dtype=torch.bfloat16), prompt_lens)
    _free()
    # zamba2 at 24 layers, 4 shared-block invocations, cut for time (+
    # DSA took ~22 s whole)
    launches.update(serve(zamba2.replace(num_layers=24), prompt_lens,
                          max_new=new_tokens)["launches"])
    _free()
    launches.update(serve(zamba2_dsa.replace(num_layers=24), dsa_lens,
                          max_new=new_tokens)["launches"])
    _free()
    falcon_serve = serve_ssm(falcon, prompt_lens, max_new=new_tokens)
    launches.update(falcon_serve["launches"])
    profile_ssm_decode(falcon, falcon_serve.pop("model"))
    del falcon_serve
    _free()
    stamp("serve.falcon")
    # phi-3-vision at full width and depth (32 layers, ~7.6 GB bf16): the
    # engine on the first mix (text-only requests), then its prefill step
    # over 576 patches; qwen3-moe, kimi-k2 (1 dense + 1 MoE layer of 384
    # experts, ~40 GB), nemotron-4 and minitron at full width, depth 2;
    # whisper-base whole through launch.steps
    phi3_serve = serve(phi3, prompt_lens, max_new=new_tokens)
    launches.update(phi3_serve["launches"])
    launches.update(serve_prefill_step(phi3, phi3_serve.pop("model"))
                    ["launches"])
    del phi3_serve
    _free()
    for cfg_ in (qwen3, kimi, nemotron, minitron):
        served = serve(cfg_.replace(num_layers=2), prompt_lens,
                       max_new=new_tokens)
        launches.update(served["launches"])
        if cfg_.num_experts:
            # [mesh]: the expert-parallel path on the served model, held
            # against the routed one at a capacity that drops nothing
            launches.update(mesh_moe(
                cfg_.replace(num_layers=2), served.pop("model"), mesh,
                ample=cfg_.num_experts / cfg_.experts_per_token)["launches"])
        del served
        _free()
    stamp("serve.registry")
    # gemma2-2b whole (26 layers, ~5.2 GB bf16) on the DSA mix, as
    # published and with DSA on its global layers
    for cfg_ in (gemma2, gemma2_dsa):
        launches.update(serve(cfg_, dsa_lens, max_new=new_tokens)
                        ["launches"])
        _free()
    stamp("serve.gemma2")
    launches.update(serve_encdec(whisper)["launches"])
    _free()
    stamp("serve")
    train_parity(yi.replace(num_layers=2), batch=1, seq=1024)
    _free()
    train_parity(yi_dsa.replace(num_layers=2), batch=1, seq=2560)
    _free()
    train_parity(yi_block.replace(num_layers=2), batch=1, seq=2560,
                 idx_tol=5e-3)
    _free()
    train_parity(falcon.replace(num_layers=2), batch=1, seq=1024)
    _free()
    # every trainer here at 4 layers, cut for time (at 8 the four took
    # ~30, ~23, ~18 and ~22 s)
    for cfg_, batch_, seq_ in ((yi_train.replace(num_layers=4), 2, 2048),
                               (yi_dsa_train.replace(num_layers=4), 1, 4096),
                               (yi_block.replace(num_layers=4), 1, 4096),
                               (falcon_train.replace(num_layers=4), 2, 2048)):
        launches.update(train_run(cfg_, batch=batch_, seq=seq_,
                                  steps=5)["launches"])
        _free()
    stamp("train")
    # the hybrid: parity at 12 layers (DSA past its top-k 2048), then the
    # trainer (K9 at d 80 or K7 at 8 x 64, K10, K11 a Mamba-2 layer)
    for cfg_, seq_ in ((z_train, 1024), (z_dsa_train, 2560)):
        train_parity(cfg_, batch=1, seq=seq_)
        _free()
    stamp("train.zamba2_parity")
    # at lr 1e-3: at the other runs' 2e-3 the unembedding's first AdamW
    # steps widen zamba2's logit spread (1.00 -> 1.21 in 5 steps on an
    # H100) faster than its few repeated tokens pay back, and the loss
    # climbs after step 1; at 1e-3 it falls
    # (+ DSA at 6 layers, one shared-block invocation, cut for time: ~24 s
    # at 12)
    for cfg_, batch_, seq_ in ((z_train, 2, 2048),
                               (z_dsa_train.replace(num_layers=6), 1, 4096)):
        launches.update(train_run(cfg_, batch=batch_, seq=seq_, steps=5,
                                  lr=1e-3)["launches"])
        _free()
    stamp("train.zamba2")
    # phi-3-vision at full width (parity at 2 layers, the trainer at 8: B 1
    # x (576 patches + 1472 tokens)) and whisper-base whole (B 8 x 448 text
    # tokens over 1500 frames; parity at B 2): K9 (d 96; whisper's encoder,
    # decoder and cross-attention), K10 (V 32064 / 51865)
    train_parity(phi3.replace(num_layers=2), batch=1, seq=2048)
    _free()
    train_parity(whisper, batch=2, seq=whisper_text)
    _free()
    for cfg_, batch_, seq_ in ((phi3.replace(num_layers=8), 1, 2048),
                               (whisper, 8, whisper_text)):
        launches.update(train_run_frontend(cfg_, batch=batch_, seq=seq_,
                                           steps=5)["launches"])
        _free()
    stamp("train.frontend")
    # gemma2 at full width, depth 26 -> 4 (2 local + 2 global), 1 x 8192,
    # fp32: parity and the trainer, as published and with DSA; then the
    # DSA indexer's warm-up (the base frozen), 3 steps
    # (+ DSA: its indexer leaves at 5e-3 of their max, the CPU tests'
    # indexer bound: their gradient, the KL's alone, is ~3.6e-7 at most, a
    # sum of terms that almost cancel; the routes' 3xTF32 rounding in K9
    # and K7 moved it by 3.5e-4 of that on an H100)
    train_parity(g_train, batch=1, seq=8192)
    _free()
    train_parity(g_dsa_train, batch=1, seq=8192, idx_tol=5e-3)
    _free()
    for cfg_ in (g_train, g_dsa_train):
        launches.update(train_run(cfg_, batch=1, seq=8192, steps=5)
                        ["launches"])
        _free()
    launches.update(train_warmup(g_dsa_train, batch=1, seq=8192, steps=3)
                    ["launches"])
    _free()
    stamp("train.gemma2")
    # [mesh]: remat on Yi-6B's training path, and the dry run's argument
    # bytes beside the card's allocation
    launches.update(mesh_remat(yi_train, batch=2, seq=2048)["launches"])
    _free()
    mesh_dryrun(yi_dsa, "yi_6b", "decode_32k", layers=2, batch=8)
    _free()
    stamp("mesh")
    # the training profiles at 2 layers (8 until the hybrid phases came,
    # 4 until slice 19's: each cut keeps the whole run near its earlier
    # time; the per-layer parts of a step halve, the loss and the
    # vocabulary's do not)
    for cfg_, batch_, seq_ in ((yi_train, 2, 2048), (yi_dsa_train, 1, 4096),
                               (yi_block, 1, 4096), (falcon_train, 2, 2048)):
        profile_train_step(cfg_.replace(num_layers=2), batch=batch_,
                           seq=seq_)
        _free()
    # zamba2 at 6 layers: one group and one shared-block invocation
    profile_train_step(zamba2.replace(num_layers=6), batch=2, seq=2048)
    _free()
    stamp("profile.train")
    profile_decode(yi)
    _free()
    profile_decode(yi_dsa, prompt_len=2304)
    _free()
    profile_decode(glm5)
    _free()
    profile_decode(zamba2)
    _free()
    profile_decode(gemma2_dsa, prompt_len=2304)        # past top-k
    stamp("profile")

    sources = {"block_sparse": "src/repro_torch/csrc/block_sparse.cu",
               "gqa": "src/repro_torch/csrc/paged_attention.cu",
               "mla": "src/repro_torch/csrc/paged_mla.cu",
               "indexer": "src/repro_torch/csrc/paged_indexer.cu",
               "lightning_indexer": "src/repro_torch/csrc/lightning_indexer.cu",
               "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
               "chunked_ce": "src/repro_torch/csrc/chunked_ce.cu",
               "mamba_scan": "src/repro_torch/csrc/mamba_scan.cu"}
    replaces = {"paged_decode_gqa":
                ("gqa", "src/repro/kernels/paged_attention/kernel.py:109"),
                "paged_prefill_gqa":
                ("gqa", "src/repro/kernels/paged_attention/prefill.py:112"),
                "paged_decode_mla":
                ("mla", "src/repro/kernels/paged_attention/kernel.py:198"),
                "paged_prefill_mla":
                ("mla", "src/repro/kernels/paged_attention/prefill.py:203"),
                "paged_indexer_scores_kernel":
                ("indexer", "src/repro/kernels/paged_attention/kernel.py:271"),
                "paged_prefill_indexer":
                ("indexer",
                 "src/repro/kernels/paged_attention/prefill.py:277"),
                "lightning_indexer":
                ("lightning_indexer",
                 "src/repro/kernels/lightning_indexer/kernel.py:37"),
                "block_sparse_attention":
                ("block_sparse",
                 "src/repro/kernels/sparse_attention/kernel.py:69"),
                "flash_attention":
                ("flash_attention",
                 "src/repro/kernels/flash_attention/kernel.py:81"),
                # K9's bf16 route (the bf16 tensor-core tile): the RL loop
                # backend's re-forward; its launches are the rl phase's
                # bf16 ones
                "flash_attention_bf16":
                ("flash_attention",
                 "src/repro/kernels/flash_attention/kernel.py:81"),
                "chunked_ce":
                ("chunked_ce", "src/repro/kernels/chunked_ce/kernel.py:70"),
                "mamba_scan":
                ("mamba_scan", "src/repro/kernels/mamba_scan/kernel.py:46"),
                # K11's head-shared (Mamba-2) form: the reference runs that
                # scan as a lax.scan (layers/ssm.py, _mamba2_scan); on the
                # TPU its kernel is K11's
                "mamba_scan_heads":
                ("mamba_scan", "src/repro/kernels/mamba_scan/kernel.py:46")}
    destroy_host_mesh()
    # K11's launches: both entry points (the main path runs the model form)
    launches["mamba_scan"] += launches.pop("mamba_scan_model")
    kernels = []
    for name, (src, where) in replaces.items():
        t = timing[name]
        kernels.append(dict(
            name=name, route="cuda", source=sources[src],
            replaces=where, launches=launches[name],
            max_abs_err=max(t["max_abs_err"], worst.get(name, 0.0)),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
