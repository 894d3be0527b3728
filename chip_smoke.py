#!/usr/bin/env python3
"""Smoke run of the PyTorch port (showo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the paths of Show-o 1.3B at full width (Phi-1.5: 24 layers,
hidden 2048, 32 heads; random weights from fixed seeds):

* the v1 512x512 text-to-image path (the ``t2i_512`` bench row) with the
  full MAGVIT-v2 decoder, bf16, 16-step prefix-cached MaskGIT with CFG
  1.75, batch 2, through the CLI's ``build_pipeline``, once on each
  attention route with an inference kernel: ``packed`` (the default at
  512x512), ``omni``, ``decode``, ``fused`` and ``streaming``, and its
  inpainting (every route) and extrapolation modes;
* the v1 stage-1 trainer (``configs/showo_pretraining_stage1.yaml``,
  warmup 0) through ``build_trainer`` on the ``trainable`` route: the
  frozen full MAGVIT-v2 encoder, 15 t2i + 4 lm + 10 mmu rows of 387
  tokens at 256x256, AdamW, clip 1.0, remat "full", bf16 autocast over
  fp32 master weights, a seeded in-memory batch;
* the v1 512x512 trainer (``configs/showo_instruction_tuning_1_512x512
  .yaml``, warmup 0) the same way: 5 t2i + 2 lm + 5 mmu rows of 1408
  tokens at 512x512, no clipping; past the packed trainable budget, so
  every layer takes the K-blocked trainable kernels (kernel 8);
* v1 multimodal understanding (``configs/showo_demo.yaml``, 256x256, the
  full MAGVIT-v2 encoder, bf16) through ``inference_mmu.build_pipeline``:
  one image, one question, 100 greedy tokens over the KV cache, with bf16
  weights and with weight-only int8 (``int8=1``: every matmul of Phi on
  the int8 kernel);
* the CLIP-ViT understanding path (``configs/showo_demo_w_clip_vit.yaml``:
  CLIP-L/14-336 features projected into the prompt), int8;
* Show-o2 1.5B text-to-image at 432x432 (``configs/showo2_1.5b_demo_432x432
  .yaml``: Qwen2.5-1.5B, 28 layers, 12 q / 2 kv heads of 128; the SigLIP
  tower, 26 layers; the DiT head, 10 layers, 32 q / 8 kv heads of 64; the
  Wan2.1 VAE decoder in fp32) through ``inference_t2i_v2.build_pipeline``:
  50-point Euler, CFG 7.5, batch 4 (8 rows with the null prompts), bf16,
  the packed route (kernel 1 at head dims 128 and 64); then with the
  prefix cache, DPM-Solver++ 20, Heun 50, dopri5, and the streaming
  route (kernel 5) without and with the cache;
* Show-o2 1.5B multimodal understanding at 432x432 (the same config: the
  Wan2.1 VAE encoder in fp32, SigLIP and Qwen2.5, dense attention as in
  JAX) through ``inference_mmu_v2.build_pipeline``: one image, one
  question, 100 greedy tokens over the KV cache, with bf16 weights and
  with weight-only int8 (every Qwen2 matmul and the tied head on kernel
  9); and video understanding (9 frames, 3 latent frames) through
  ``inference_mmu_vid.build_pipeline``, bf16;
* Show-o2 1.5B text- and image-to-video (bench.py's ``t2v`` and
  ``t2v_long`` rows) through ``inference_t2i_v2.build_t2v_pipeline``,
  mixed-modality generation through
  ``inference_mixed_modality.build_pipeline``, and Show-o v1 long video
  (``configs/showo_demo.yaml``) through ``inference_lvg.build_pipeline``;
* continuous-batching serving (bench.py's four ``serve_*`` rows): Show-o
  1.3B int8 through ``serving.ShowoMMUServer`` and Show-o2 1.5B int8
  through ``serving.Showo2MMUServer``;
* the Show-o2 1.5B stage-1 trainer (``configs/showo2_1.5b_stage_1_a.yaml``,
  warmup 0) through ``show_o2/train_stage_one.py::build_trainer`` on the
  ``trainable`` route: the frozen Wan2.1 encoder, SigLIP frozen, Qwen2.5
  and the DiT trained with AdamW, remat "full", bf16 autocast over fp32
  master weights, 12 rows (10 t2i, 2 und) of 1024 tokens at 432x432; and
  its CLI at a reduced depth, with checkpoints and a resume;
* the throughput modes: kernel 2's bf16-score variant in the 512x512
  ``fused`` generate, the remat rungs and optimizers of
  ``utils/remat.py`` / ``training/optim.py`` on the Show-o2 trainer, and
  bench.py's four training rows (``train_v1``, ``train_v1_fast``,
  ``train_v2``, ``train_v2_fast``) through their trainers;
* the Show-o2 1.5B mixed-modality trainer
  (``configs/showo2_1.5b_downstream_mixed_modality_simple.yaml``, warmup
  0) through ``show_o2/train_mixed_modality.py::build_trainer`` on the
  config's ``trainable`` route (kernel 8 in both towers): 2 VIST samples
  of 4352 rows, 4 images of 432x432 a sample, under the recipe's phase-1
  freeze and with every weight trained; and its CLI's two-phase recipe at
  a reduced depth, the second phase resuming with the weights-only
  fallback;
* the v1 stage-1 CLI (``training/train_showo.py::main``) at a reduced
  depth on ``trainable`` (kernel 7): its data through ``_build_loaders``
  (an ImageNet-style folder, a tar shard read by the native reader, a
  parquet file), checkpoints with the EMA and the loaders' positions,
  validation images and prediction panels, and a resume;
* Show-o2 1.5B stage 2 on LLaVA-OneVision conversations
  (``configs/showo2_1.5b_stage_2_a.yaml``) through
  ``show_o2/train_stage_two.py``: the CLI's loader (jsonl t2i rows and
  ``MMUDataset`` rows of ``annotation_path``), the trainer on
  ``trainable`` under the 2a freeze and with every weight trained, and its
  CLI at a reduced depth with a resume;
* the Show-o v1 CLIP-ViT trainer (``configs/showo_instruction_tuning_2_w_
  clip_vit.yaml``: LLaVA conversations, the frozen CLIP-ViT-L/14-336,
  ``mm_projector`` at twice the rate, dense) through
  ``training/train_showo_clip.py``: its step at full width and depth, and
  its CLI (``llava_pretrain``, then ``llava_tuning`` resuming) at a
  reduced depth;
* the evaluation chain (``showo_tpu_torch/evaluation/``) on random weights
  and items written for the run: ``run_chain`` (GenEval, DPG with its
  scoring, FID) on phase 14's v1 512x512 pipeline, ``run_mmu_eval`` on
  phase 10's int8 v1 and phase 18's Show-o2 understanding pipelines, both
  CLIs at a reduced depth (``mmu_eval`` also as ``python -m`` in a fresh
  interpreter), and the VQ PSNR gate on the full MAGVIT-v2.

Phases, one or more lines each:

  1. device: card name and power limit, torch / CUDA versions; TF32 off
  2. build: nvcc builds the ten kernel sources of csrc/, in parallel, and
     ptxas' registers and spills of each entry function with its template
     arguments (the forward core <head dim, mask, split, W, bf16 scores>
     at <64, 0> and <128, 0> (the -inf mask: kernels 5, 7, 8), <64, 1>
     and <128, 1> (the -1e30 mask: kernels 1 and 4), <64, 1, true> (kernel
     2: K / V from two sources, keys at positions) and <64, 1, true, 1,
     true> (its bf16-score variant), <64, 2> (the bias: kernel 3), and
     kernel 6's <64, 1, false, W> for W = 1..4 and <128, 1, false, W> for
     W = 1, 2 (W warpgroups, one q head each); kernel 2's norm_rope_kernel;
     the decode gemv <nibbles, aligned, rows>), and "wgmma serialized"
     where ptxas warned C7515
  3. kernel vs plain: each inference kernel at the cached step's shapes
     (B=4, P=129, H=32, D=64, bf16, metadata of a left-padded t2i
     layout), all on the wgmma forward core, each on the tile map its
     forward makes once, which must equal its plain version byte for
     byte: the packed kernel (kernel 1) at 512x512 and one GQA case;
     omni, decode, fused and streaming at 512x512 (Q=1026, K=1155) and
     256x256 (Q=258, K=387), streaming also with GQA; omni (kernel 4) and
     streaming (kernel 5) beside kernel 1 on the same memory, their
     outputs' max difference (omni: 0, the same function through the same
     core); fused (kernel 2) as a whole and as its two launches, the
     LayerNorm + RoPE pass (within 2 bf16 ulps of each head row's peak)
     and the core over [cache | fresh] keys at their positions, with
     ``scaled_dot_product_attention`` on the normed q / k under the same
     mask as the core's yardstick; decode (kernel 3, under the bias) on
     the bias's tile map; max abs error, median times (CUDA events) of
     kernel, plain version and one library call of the same function,
     and the bound
  4. the t2i slice, per route: over one generate call the route's kernel
     launches 24 layers x 16 steps times, all on the wgmma core, reading
     16 tile maps (one a forward: of the metadata on ``packed``,
     ``omni``, ``streaming``, of kernel 2's keys on ``fused``, of the
     bias on ``decode``), on ``fused`` each launch after its LayerNorm +
     RoPE pass (384), and every other kernel none; codes in the
     codebook; images finite, NHWC, in [-1, 1]; warm seconds per batch
     and images/min
  5. step parity, per route: one full-width cached step with the route's
     kernel and with dense attention under the additive mask, max abs
     logit difference
  6. trainable kernels (kernel 7) vs plain: forward (out, lse), dq and
     dk/dv at the stage-1 shape (B=29, S=387, H=32, D=64, bf16, metadata
     of the trainer's fused batch), a GQA case and a ragged S=200 with
     rows that see no key; kernel 7 runs the wgmma cores (the forward on
     csrc/attention_fwd_sm90.cuh, dq and dk/dv on
     csrc/attention_grad_sm90.cuh) after its tile map, which must equal its
     plain version byte for byte, each giving the same bits over two
     launches; errors, median times of kernel, plain version and
     ``scaled_dot_product_attention`` with the boolean mask (forward,
     backward, forward + backward), and the bounds; then the same checks
     on two faults planted in the plain versions (V of the wrong kv head,
     one K tile dropped), each of which must fail them
  7. the stage-1 training slice: the first step, then TRAIN_STEPS steps
     on the same batch with every launch count set to 0 before them: per
     step 48 forward launches (24 layers + 24 recomputed by remat), 24 dq,
     24 dk/dv and 48 tile maps (each forward makes one, its backward reads
     it again), none of the other kernels; losses finite and falling;
     median step time, samples/s, peak device memory
  8. stage-1 training step parity: one full-width step's losses and grad
     norm on ``trainable`` against ``dense``, same weights, batch and
     draws
  6b. kernel 8 vs plain as phase 6, on head-major views of [B, S, H, D]
     tensors (phi's layout) at the 512x512 fused batch (B=12, S=1408),
     a GQA case and the ragged case, with the same planted faults; the
     count of the batch's rows that see no key; kernel 8 runs the same
     wgmma cores as kernel 7 after its tile map, checked as there; then at
     the same shape (past kernel 7's budget), on the same memory, kernel
     7's cores beside kernel 8, times of the two sets
  7b. the 512x512 training slice as phase 7: 48 / 24 / 24 / 48 launches of
     kernel 8's forward, dq, dk/dv and tile map per step (the forward makes
     the map, the backward reads it again), none of kernel 7 or of the
     inference kernels; the step beside the last recorded one
  8b. the 512x512 training step parity as phase 8
  9. the weight-streaming matmuls (kernels 9-11) vs plain: int8 at the
     understanding slice's win / wout / lm_head shapes at decode (M=1) and
     at the prefill's rows (267), win at the CLIP-ViT prefill's 609 rows,
     a ragged M=65 at lm_head's N=58498, int8 and int4 at the probes' [8,
     2048] x [2048, 8192], and int4 at win's M=267 and M=609, the ragged
     lm_head M=65 and win / wout / lm_head at M=1; error within 2e-2 of
     the output's peak and a
     planted fault (each column scaled by its neighbour's scale) that must
     fail it; median CUDA-event times of kernel, plain version,
     torch.matmul on dequantized bf16 weights (the library) and the eager
     dequantize + matmul, the same without the host (profiler device
     time), the bound; the core that ran (the decode gemv at M=1, the
     source's prefill kernel above M=4), the same bits on two calls, the
     device launches a product (one for the gemv); above M=4 the first mma
     kernel checked and timed beside the prefill kernel on the same inputs;
     then kernel 9 at Qwen2.5-1.5B's products (the fused qkv with its bias,
     o, gate-up, down, the tied lm_head of N = 151940 on rows padded to
     151952) at M=1 and at the v2 image prompt's 746 rows: the same checks
     (error, planted fault, core, bits), event and device times of kernel,
     plain version and the library, and the bound; then kernel 9 at the
     serving engine's rows (M = 8 and 24: slots x a decode window of 1 or
     3 rows; 328: a fused admission of 8 lanes and a 320-row prompt) at
     Phi's win / wout / lm_head and Qwen's five products, the same checks
  10. the discrete understanding slice, bf16 then int8 weights: per answer
     the int8 kernel launches 49 x 101 times with int8 (24 win + 24 wout +
     lm_head, prefill and 100 decode forwards: 49 on the prefill kernel,
     4900 on the gemv) and never with bf16, every
     other kernel none (counted over the first answer); tokens in the
     vocabulary; prompt and prefill times (medians of 3), one warm
     answer's and the decode time it gives, tokens/s against the
     weight-streaming bound, peak memory, device idle share over one
     answer (profiler), device busy per token and the gemv's device
     launches and time per token; then one answer of each pipeline in
     turns, twice
  11. prefill logits with int8, bf16 and fp32 weights on the same seeded
     model: int8 vs fp32 within the JAX package's int8 limits (top-1
     agreement >= 0.95, max abs difference / peak < 0.05), the other
     pairs read beside it
  10b. the CLIP-ViT path with int8 weights as phase 10, after the CLIP
     tower's features (576 x 1024, timed)
  3c. kernels 1 and 6 at the Show-o2 432x432 slice's shapes: B=8 rows, S
     the slice's truncated sequence, its span metadata; Qwen2.5 (12 q / 2
     kv heads, D=128) and the DiT (32 / 8, D=64), kernel 1 on the wgmma
     core of csrc/attention_fwd_sm90.cuh at both (every launch counted
     there), after its tile map, which must equal its plain version byte
     for byte; kernel 6 (the same core, its q heads of a kv head sharing
     each K / V tile, every launch counted there) beside kernel 1 on the
     same inputs and map, their outputs' max difference (0: each head's
     arithmetic is kernel 1's); the fault of V read from the neighbouring
     kv head planted in each plain version must fail the check; median
     times of kernel, plain version and scaled_dot_product_attention with
     the boolean mask, the device time a launch of each (profiler), and
     the bound; then kernel 1 at both head dims on a ragged S=200 whose
     rows 6..9 see no key (they must average v over the S keys), the same
     bits over two launches
  12. the Show-o2 slice: over one generate call kernel 1 launches 38 x 49
     times (28 Qwen + 10 DiT layers, 49 velocity evaluations), all on the
     wgmma core, all reading one tile map made with the generate's
     metadata; every other kernel (kernel 6 among them) none;
     images finite, NHWC, in [-1, 1]; warm seconds per batch, images/min,
     peak device memory
  13. one full-width velocity evaluation on the packed route against
     dense attention under the additive mask: the same weights (the
     zero-initialised adaLN and final projections drawn N(0, 0.02) so that
     the velocity depends on the towers), latents and t; max |dv| over the
     dense velocity's peak
  14. (after phase 5) the v1 modes at 512x512 on the full-width slice
     model: inpainting with the in-tree pair (``assets/validation/
     inpainting``) on every inference route, 384 launches of the route's
     kernel and 16 tile maps per inpaint, the unmasked tokens kept; then
     extrapolation up then down on ``packed`` (2 x 384 launches), a 64 x 32
     code grid decoded to 1024 x 512 images; codes in the codebook,
     images finite in [-1, 1], warm seconds
  15. kernels 1 and 5 at the Show-o2 slice's cached shapes: the 730 fresh
     rows of the [cond; null] spans at the generate's per-row offsets (14
     / 11 for the prompts, 2 for the null rows) against K=768 cached keys,
     Qwen2.5 (12 / 2, D=128) and the DiT (32 / 8, D=64), through the
     model's call on [B, S, H, D] views; each against its plain version,
     its tile map (made once a generate with the fresh rows' metadata)
     byte for byte, two launches bit-identical, a fault planted in the
     plain version (one row's offset + 1) failing the check; median
     times of kernel, plain version and scaled_dot_product_attention with
     the boolean mask, device time a launch, bound
  16. the Show-o2 slice with ``prefix_cache=True`` (Euler 50, phase 13's
     weights): 38 x (1 prefill + 49 cached evaluations) = 1900 kernel 1
     launches per generate, all on the wgmma core, 2 tile maps (the
     prefill's rows, the fresh rows'); latents against the uncached
     pipeline on the same noise (max |d| over the peak); warm seconds in
     turns with ``prefix_cache=False``; peak memory
  17. the samplers: DPM-Solver++ at 20 points, Heun at 50, dopri5 (its
     velocity evaluations and steps printed), kernel 1 launches 38 a
     velocity evaluation; then the ``streaming`` route (kernel 5 in all
     38 layers, D=128 and 64) without and with the prefix cache, 38 x 49
     / 38 x 50 launches and 1 / 2 tile maps, latents against ``packed``;
     seconds and images/min beside Euler
  18. Show-o2 image understanding (after phase 17), bf16 then int8 on a
     copy of the model: per int8 answer kernel 9 launches 113 x 101 times
     (28 x (qkv, o, gate-up, down) + lm_head, the prefill's 113 on the
     prefill kernel, 11300 on the gemv), none with bf16, and no attention
     kernel in either; tokens in the vocabulary; VAE encode, prompt and
     prefill times (medians of 3), one warm answer's, decode tokens/s
     against the weight-streaming bound (3.087 GB a token in bf16, 1.543
     GB in int8), peak memory, the device idle share over one answer; then
     the prefill logits of one scaffold with int8, bf16 and fp32 Qwen2
     weights of the same seeds and with the int8 weights computed exactly
     in fp32: int8 on kernel 9 held to that exact int8 model (max abs
     difference / peak < 0.05, top-1 agreement no more than 0.02 below
     bf16's against fp32); int8 vs fp32 read beside it, not held (on
     these random weights the exact int8 model itself agrees with fp32 on
     ~0.88 of the rows)
  18b. Show-o2 video understanding, bf16: 9 frames made from the in-tree
     image, read by ``load_video``; 3 latent frames, the prompt rows, one
     greedy answer's tokens in the vocabulary, no kernel, its wall time
  19. bench.py's ``t2v`` row (after phase 18b): 1 prompt (2 rows with the
     null prompt), 2 latent frames (S=1536), Euler 20, CFG 5.0, the
     adaLN drawn as in phase 13; kernel 1 at its shapes (Qwen2.5 and DiT
     heads) against its plain version and the library on the generate's
     tile map (byte for byte), held to the max abs error and to the
     largest error of a row relative to its size, which a fault planted
     in the reference (one 64-key tile of the video spans masked) must
     fail; two launches bit-identical, device times, bound; one generate: 38 x 19 = 722 kernel 1 launches, all on the
     core, 1 tile map, frames finite in [-1, 1], denoise and decode
     seconds, frames/min, peak memory; one velocity on ``packed``
     against ``dense``; an i2v generate (the in-tree image as the first
     frame, which must come out as the encoder gave it)
  19b. ``t2v_long``: 9 latent frames (S=6656) on ``streaming`` as phase
     19 with kernel 5, the streaming VAE decode of 33 frames in the
     generate; the velocity against ``dense`` (``packed`` if dense does
     not fit); the streaming against the full-clip decode in fp32
     (cuDNN's TF32 off for the check)
  20. mixed modality: 2 rounds of up to 60 top-k 5 tokens and an image
     each (Euler 20, CFG 5.0, dense as in JAX: no kernel); round texts
     and images well formed; one round's text timed without the
     profiler, its decode ms a token apart from the prefill; the idle
     share over a profiled run of it; seconds an image
  21. v1 long video at 256x256: batch 2, 3 frames, 2 context frames, 16
     steps, CFG 1.75 (dense under the lvg mask: no kernel); codes in the
     codebook, every frame differing from the one before, seconds a frame
  22. serving, v1: bench.py's ``serve_v1_spec2_int8`` (greedy, 2 drafts,
     32 requests), ``serve_v1_sampled`` (temperature 0.9, top-p 0.9, 64
     requests) and ``serve_v1_spec2_sampled`` (the same with 2 drafts: the
     engine's A/B probation) through ShowoMMUServer on the int8 model of
     ``inference_mmu.build_pipeline``: 8 slots, chunk 16, buckets 320 / 384
     / 448, bench.py's cap, workload (seed 5) and warm-up; per row output
     tokens/s, TTFT p50 / p95, seconds, decode steps, windows, host syncs a
     window (1), kernel 9 launches a decode step, prefill and admission
     (49 each) and none of any other kernel, peak memory, the idle share
     of one profiled decode window of one chunk, the A/B choice, the share
     of drafts accepted; every budget met with ids in the vocabulary; the
     teacher-forced check of every request against the single-request
     model (greedy: each token's reference logit within GREEDY_LOGIT_TOL of
     the top; sampled: inside the nucleus; each lane's cache rows within
     CACHE_ROW_TOL), which a planted fault (lane 0's K/V scattered at its
     length + 1) must fail; one greedy plain decode chunk under
     ``torch.cuda.set_sync_debug_mode("error")``
  22b. serving, v2: ``serve_v2_spec2_int8`` (12 embedding prompts of 762-793
     rows, buckets 768 / 832, 2 drafts, greedy) through Showo2MMUServer on
     the int8 model of ``inference_mmu_v2.build_pipeline``, as phase 22 (113
     kernel 9 launches a step and a prefill)

  23. kernels 7 and 8 at head dim 128 (Qwen2.5's 12 q / 2 kv heads) on
     the metadata of the Show-o2 stage-1 batch (B=2): kernel 7 at S=1024,
     kernel 8 at S=2048, each its tile map byte for byte, forward, lse,
     dq and dk/dv against the plain versions and bit-stable over two
     launches, CUDA-event medians of kernel, plain version and
     ``scaled_dot_product_attention`` under the same mask, device times,
     bounds; the planted faults (V of the wrong kv head, one 64-key tile
     dropped from the plain version's mask) each failing the check
  24. the Show-o2 stage-1 trainer at full width: a warm step, then
     V2_TRAIN_STEPS steps of one batch with one fixed draw: per step 76
     kernel 7 forwards (28 Qwen2.5 + 10 DiT layers, twice under remat), 38
     dq, 38 dk/dv (56 / 28 / 28 of them at head dim 128) and 76 tile
     maps, none of any other kernel; losses finite and falling; s per
     step, samples/s, peak memory, the idle share of one profiled step;
     one step of 2 rows x 2048 tokens, where both towers take kernel 8
  25. Show-o2 training step parity: one full-width step's losses and grad
     norm on ``trainable`` against ``dense`` (the same prepared batch:
     weights, draws and rows; only the attention inputs differ)
  26. the stage-1 CLI in process (``train_stage_one.main``) at full width
     and depth 2 / 2 / 2 on a jsonl of the in-tree image: 2 steps with
     ``save_every`` 1, then a resume from ``latest`` to step 3
  27. kernel 2's bf16-score variant (``attn_fp32=False``) at the 512^2
     cached step against its plain version in bf16 softmax, with a planted
     fault (the split off by one row) that must fail the check; event and
     device ms beside the fp32 core on the same memory, the library on the
     core's part; then the 512x512 ``fused`` pipeline with
     ``model.showo.attn_fp32=False`` beside the fp32 one: 384 cores (all
     bf16) + 384 passes + 16 maps a generate, s a generate in turns, token
     agreement with the fp32 generate
  28. the training throughput modes: on phase 24's trainer each remat rung
     (``none``, ``qkv``, ``qkv_fc1``, ``qkv_attn``, ``qkv_fc1_attn``,
     ``dots``) against ``full`` on one prepared batch (phase 25's limits);
     the ladder of rungs under AdamW and adafactor at 12 rows (s a step,
     peak memory, kernel 7's launches a step, or "out of memory", a
     reading); one 16-row step under adafactor + ``qkv_fc1_attn``; then
     bench.py's ``train_v1``, ``train_v1_fast``, ``train_v2`` and
     ``train_v2_fast`` rows through their ``build_trainer`` (dense, the
     mode from the config): a warm step and 3 on one batch, losses
     falling, s a step, samples/s, peak memory
  29. Show-o2 mixed-modality training at full width and depth on
     ``trainable``: 2 VIST samples x 4352 rows (4 images of 432x432 a
     sample, one (0, 0) span), a warm step and MIXED_STEPS steps under the
     phase-1 freeze, then the same with every weight trained (a new
     optimizer): per step 76 kernel 8 forwards, 38 dq, 38 dk/dv (56 / 28
     / 28 at head dim 128), 76 tile maps, none of any other kernel; s a
     step, samples/s, peak memory; then one step's losses and grad norm on
     ``trainable`` against ``dense`` (phase 25's limits)
  30. the mixed-modality CLI's two-phase recipe at full width and depth 2
     / 2 / 2: phase 1 (the config's freeze) 2 steps with checkpoints;
     phase 2 (``frozen_params=[]``) resumes from ``latest`` with the
     weights-only fallback (its warning read from the log) and a fresh
     optimizer, to step 3
  31. the v1 stage-1 CLI at full width and depth 2 on ``trainable``: the
     data through ``_build_loaders`` (which tar and image paths ran is
     printed), ``save_every`` 1, ``generate_every`` 1, the EMA on: 2 steps
     (8 / 4 / 4 / 8 kernel 7 launches, none of any other kernel), then a
     resume from ``latest`` to step 3 with the EMA and the three loaders'
     positions restored
  32. Show-o2 stage 2 at full width and depth on ``trainable``: one batch
     of the CLI's loader (4 t2i jsonl rows and 4 conversation rows of 1024
     at 432x432, one image each, on their shared keys), under the 2a
     freeze, then with every weight trained (a new optimizer): a warm step
     and STAGE2_STEPS steps each, per step 76 kernel 7 forwards, 38 dq, 38
     dk/dv (56 / 28 / 28 at head dim 128), 76 tile maps, none of any other
     kernel; s a step, samples/s, peak memory; each stage's step on
     ``trainable`` against ``dense`` (phase 25's limits)
  33. the stage-2 CLI with ``annotation_path`` at full width and depth 2 /
     2 / 2 (2 steps with checkpoints, a resume from ``latest`` to step 3
     with the loaders' positions; kernel 7's launches counted); the
     CLIP-ViT trainer's CLI at full width and Phi depth 2 (the tower
     whole): ``llava_pretrain`` 2 steps, then ``llava_tuning`` resuming
     from its latest to step 3; no kernel launched
  34. the CLIP-ViT trainer's step at full width and depth (3 t2i + 1 lm +
     4 mmu rows, dense, bf16 autocast): a warm step and CLIP_TRAIN_STEPS
     steps, s a step, samples/s, peak memory, no kernel launched; one
     step's losses under bf16 autocast against the same step in fp32 on
     the same batch and draws (phase 25's loss limit)
  35. the evaluation chain on items written to a temporary directory (a
     GenEval jsonl, a DPG prompt and csv, crops of the in-tree image, POPE
     / MME / GQA jsonl files), each part run where the script holds its
     pipeline: 35a (after phase 14) ``run_quality.run_chain`` on phase
     14's v1 512x512 pipeline (``build_pipeline``, ``auto``: ``packed``),
     one step a call: GenEval 2 prompts x batch 2, the first prompt's PNGs
     identical to a direct ``generate`` with a generator of the same seed;
     DPG 1 prompt x batch 4, its grid scored by ``MMUPipelineScorer`` on
     the bf16 MMU pipeline of ``run_quality._build_scorer`` (4 crops x 3
     propositions, one dependency); FID of 4 validation prompts against 4
     crops with the random-projection extractor; kernel 1 384 launches a
     generate, all on the core, 16 tile maps, no other kernel; each
     summary written as returned, no step skipped; 35b (after phases 11
     and 18) ``run_mmu_eval``: 4 POPE items of 100 tokens on phase 10's
     int8 v1 pipeline (kernel 9: 49 prefill launches and 4900 gemv
     launches an answer), 2 MME questions of 20 tokens on phase 18's bf16
     Show-o2 pipeline (no kernel), the metrics files equal to the returned
     dicts; 35c (after phase 34) the ``run_quality`` (steps=geneval,fid,
     the smoke extractor) and ``mmu_eval`` (GQA, int8) CLIs' ``main`` in
     this process at Phi depth 2, their launches counted, then ``python
     -X importtime -m showo_tpu_torch.evaluation.mmu_eval`` with the same
     arguments in a fresh interpreter: the same metrics and predictions,
     the kernel 9 wrapper imported, no module of JAX or ``showo_tpu``; 35d
     ``vq_psnr`` at 256x256 on the full-width MAGVIT-v2: the round trip's
     shape and the CLI's printed PSNR; seconds of each beside the card's
     name and power limit

Then a JSON line of kernel results, the nvidia-smi name/power line, and
as the last line ``{"ok": true, "device": {...}}``.  Any failure raises
and exits non-zero with no result line; without CUDA it exits 2.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time

CARD_TOL = 2e-2      # kernel vs plain, max abs error of bf16 attention
#                      outputs (averages of ~N(0, 1) values) and of lse
GRAD_TOL = 1e-2      # kernel vs plain, gradients: ||kernel - plain|| /
#                      ||plain|| (their size varies by rows; no peak scale)
STEP_TOL = 1e-1      # max |logit| difference, kernel vs dense, full step
# trainable vs dense, one full-width training step under bf16 autocast:
# the routes round P to bf16 at different points (the kernels before
# normalising, the dense path after), so the 24 layers differ by bf16
# noise; relative difference of each loss part (read on an H100: 2e-6 to
# 8.1e-5 over two builds of the kernels), and of the grad norm (read:
# 5.9e-5 to 2.1e-4), 6-10x above the largest readings
TRAIN_LOSS_TOL, GRAD_NORM_TOL = 5e-4, 2e-3
# the same at 512x512 (phase 8b, S=1408): after phase 7b's five steps on
# one batch the mmu loss is down to ~0.8, so the same absolute bf16 noise
# (1.5e-3, against 2.6e-4 at stage 1) is a larger share of it; read on an
# H100 at 700 W: losses 7.8e-6 to 1.9e-3 (loss_mmu), grad norm 1.2e-3
TRAIN512_LOSS_TOL, TRAIN512_GRAD_NORM_TOL = 1e-2, 1e-2
NUM_LAYERS, TIMESTEPS, BATCH = 24, 16, 2
P, H, D = 129, 32, 64            # text prefix rows, heads, head dim
TRAIN_STEPS = 4
# H100 SXM peaks (NVIDIA data sheet): device memory rate, dense bf16 rate,
# fp32 outside the tensor cores
HBM_BYTES_PER_S, BF16_FLOPS_PER_S = 3.35e12, 989e12
FP32_OPS_PER_S = 67e12

# route -> (kernel source name, the TPU kernel it replaces)
KERNELS = {
    "packed": ("omni_attention_packed",
               "showo_tpu/ops/flash_attention.py:232"),
    "omni": ("omni_attention", "showo_tpu/ops/flash_attention.py:87"),
    "decode": ("decode_attention", "showo_tpu/ops/decode_attention.py:69"),
    "fused": ("fused_decode", "showo_tpu/ops/fused_decode.py:114"),
    "streaming": ("streaming_attention",
                  "showo_tpu/ops/streaming_attention.py:116"),
}
# the trainable route's kernels, three and a tile map per source: counter
# name -> (the Pallas kernel it replaces, launches per training step; remat
# "full" runs each layer's forward twice, and each forward makes its map).
# Kernel 7 takes the stage-1 rows (S=387), kernel 8 the 512x512 rows
# (S=1408, past the packed budget); both run the wgmma cores.
TRAIN_SOURCE = "packed_attention_grad"
TRAIN_KERNELS = {
    "packed_attention_grad_fwd": (
        "showo_tpu/ops/packed_attention_grad.py:56", 2 * NUM_LAYERS),
    "packed_attention_grad_dq": (
        "showo_tpu/ops/packed_attention_grad.py:97", NUM_LAYERS),
    "packed_attention_grad_dkv": (
        "showo_tpu/ops/packed_attention_grad.py:138", NUM_LAYERS),
    # the Pallas kernels' mask (_mask, computed per block in each of them)
    "packed_attention_grad_tiles": (
        "showo_tpu/ops/packed_attention_grad.py:43", 2 * NUM_LAYERS),
}
STREAM_TRAIN_SOURCE = "streaming_attention_grad"
STREAM_TRAIN_KERNELS = {
    "streaming_attention_grad_fwd": (
        "showo_tpu/ops/streaming_attention_grad.py:56", 2 * NUM_LAYERS),
    "streaming_attention_grad_dq": (
        "showo_tpu/ops/streaming_attention_grad.py:104", NUM_LAYERS),
    "streaming_attention_grad_dkv": (
        "showo_tpu/ops/streaming_attention_grad.py:142", NUM_LAYERS),
    # the tile map, made by each forward and read again by its backward:
    # the Pallas kernels' block skip (_visible and jnp.any in _fwd_kernel,
    # _dq_kernel and _dkv_kernel, called from _fwd and _bwd)
    "streaming_attention_grad_tiles": (
        "showo_tpu/ops/streaming_attention_grad.py:282", 2 * NUM_LAYERS),
}
# the 512x512 step with the first forward kernel of kernel 8 (PERF.md §5,
# H100 80GB HBM3 at 700 W), printed beside phase 7b's
STEP512_BEFORE = "0.94-0.95 s"
# the weight-streaming matmuls (kernels 9-11), one source each: counter
# name -> the Pallas kernels it replaces
WSMM_KERNELS = {
    "int8_matmul": "tools/probe_int8_decode.py:64 (kernel 9); "
                   "tools/probe_pallas_wsmm.py:66 (kernel 11a)",
    "int4_matmul": "tools/probe_int4_decode.py:79 (kernel 10); "
                   "tools/probe_pallas_wsmm.py:123 (kernel 11b)",
}
# each source's prefill kernel (M > 4, aligned rows:
# csrc/weight_stream_prefill.cuh), which replaced its first mma kernel there
PREFILL_KERNEL = "int8_matmul_prefill"
INT4_PREFILL_KERNEL = "int4_matmul_prefill"
# the per-core counters of the weight-streaming sources
WSMM_CORES = ["int8_matmul_gemv", "int8_matmul_mma", PREFILL_KERNEL,
              "int4_matmul_gemv", "int4_matmul_mma", INT4_PREFILL_KERNEL]
# kernel 6, the GQA-stacked packed attention: on no model path (the JAX
# package reaches it only through omni_attention_packed(gqa_stack=True))
GQA_SOURCE, GQA_REPLACES = ("omni_attention_gqa_stacked",
                            "showo_tpu/ops/flash_attention.py:338")
# its launches on the wgmma forward core (all of them), and the tile maps it
# makes when not given one
GQA_WGMMA, GQA_TILES = f"{GQA_SOURCE}_wgmma", f"{GQA_SOURCE}_tiles"
# kernel 1's launches on the wgmma forward core (all of them, at head dims
# 64 and 128), also counted under omni_attention_packed, and its tile map
# (the Pallas kernel's mask, computed per block from the metadata)
PACKED_WGMMA = "omni_attention_packed_wgmma"
PACKED_TILES = "omni_attention_packed_tiles"
# the tile maps of kernels 4 and 5 (kernel 1's kind, of the metadata), 2
# (of its keys at their positions) and 3 (of the bias), one a forward:
# route -> counter
ROUTE_TILES = {"packed": PACKED_TILES, "omni": "omni_attention_tiles",
               "fused": "fused_decode_tiles",
               "streaming": "streaming_attention_tiles",
               "decode": "decode_attention_tiles"}
# kernel 2's LayerNorm + RoPE pass, one before each launch of its core
FUSED_NORM = "fused_decode_norm_rope"
# Show-o2 1.5B stage-1 training (phases 23-26): configs/showo2_1.5b_stage_1_a
# .yaml with warmup 0; a batch of V2_TRAIN_BATCH rows of 1024 tokens (the
# config's max_seq_length) at 432x432, and one of 2048 tokens, whose length
# sends both towers past the packed budget to kernel 8
V2_TRAIN_CONFIG = "configs/showo2_1.5b_stage_1_a.yaml"
# (12 rows: 64.42 GiB at peak on an H100 80GB; 16 run out of memory)
V2_TRAIN_BATCH, V2_TRAIN_STEPS, V2_TRAIN_SEQ = 12, 3, (1024, 2048)
V2_TRAIN_UND = 2            # understanding rows of the batch (the rest t2i)
V2_DIT_LAYERS = 10
# kernels 7 and 8 at Qwen2.5's head dim (phase 23): q heads, kv heads, dim
V2_TRAIN_HEADS = (12, 2, 128)
# the head-dim-128 launch counters of the trainable kernels (each launch at
# head dim 128 is also counted under the name without _d128)
D128 = "_d128"
V2_TRAIN_COUNTERS = [n + D128 for n in list(TRAIN_KERNELS)[:3]
                     + list(STREAM_TRAIN_KERNELS)[:3]]
# trainable vs dense, one full-width Show-o2 step under bf16 autocast
# (phase 25): relative difference of each loss and of the grad norm.  Read
# on an H100 at 700 W in two runs: losses 1.4e-6 to 4.5e-4 (loss_ntp, the
# 151,940-wide cross entropy of the und row, largest), grad norm 1.0e-5 to
# 2.0e-5; the limits ~11x and ~25x above the largest readings
V2_TRAIN_LOSS_TOL, V2_TRAIN_GRAD_NORM_TOL = 5e-3, 5e-4
# kernel 2's bf16-score launches (attn_fp32=False; also counted under
# fused_decode), phase 27
FUSED_BF16 = "fused_decode_bf16"
# bench.py's four training rows (bench.py:336-376, :444-520, SUITE
# :977-984), phase 28: name -> (slice, mode, Show-o2 rows).  v1: the stage-1
# config's 15 t2i + 4 lm + 10 mmu rows of 387 tokens at 256x256; v2: rows of
# 1024 tokens at 432x432, all t2i; bench.py's default route, dense
TRAIN_ROWS = {
    "train_v1": ("v1", dict(optimizer="adamw", remat="full",
                            softmax="fp32"), None),
    "train_v1_fast": ("v1", dict(optimizer="adafactor", remat="qkv_attn",
                                 softmax="bf16"), None),
    "train_v2": ("v2", dict(optimizer="adafactor", remat="qkv_fc1_attn",
                            softmax="fp32"), 2),
    "train_v2_fast": ("v2", dict(optimizer="adafactor",
                                 remat="qkv_fc1_attn", softmax="bf16"), 3),
}
TRAIN_ROW_STEPS = 3
# Show-o2 mixed-modality training (phases 29-30): the config, its
# batch_size_mixed_modal, max_mixed_modal_seq_length and max_num_images,
# and the timed steps of each stage of the recipe
MIXED_CONFIG = "configs/showo2_1.5b_downstream_mixed_modality_simple.yaml"
MIXED_BATCH, MIXED_SEQ, MIXED_IMAGES, MIXED_STEPS = 2, 4352, 4, 3
# the v1 stage-1 CLI (phase 31)
V1_TRAIN_CONFIG = "configs/showo_pretraining_stage1.yaml"
STAGE2_CONFIG = "configs/showo2_1.5b_stage_2_a.yaml"
STAGE2_STEPS = 3
CLIP_TRAIN_CONFIG = "configs/showo_instruction_tuning_2_w_clip_vit.yaml"
CLIP_TRAIN_STEPS = 3
# the remat ladder on phase 24's trainer (phase 28): the rungs, the
# optimizers, the timed steps of a cell, and the rows of the one larger step
RUNGS = ("full", "qkv", "qkv_fc1", "qkv_attn", "qkv_fc1_attn", "dots")
RUNG_OPTIMIZERS = ("adamw", "adafactor")
RUNG_STEPS, RUNG_BIG_BATCH = 2, 16
# every launch counter of the port's kernels
COUNTERS = ([name for name, _ in KERNELS.values()] + list(TRAIN_KERNELS)
            + list(STREAM_TRAIN_KERNELS) + list(WSMM_KERNELS) + WSMM_CORES
            + [GQA_SOURCE, GQA_WGMMA, GQA_TILES, PACKED_WGMMA, FUSED_NORM,
               FUSED_BF16, *ROUTE_TILES.values()] + V2_TRAIN_COUNTERS)
# the understanding slice: greedy answers of MMU_NEW_TOKENS tokens, one
# prefill and MMU_NEW_TOKENS decode forwards, each with 24 win + 24 wout +
# the lm_head matmul
MMU_NEW_TOKENS = 100
MMU_MATMULS = 2 * NUM_LAYERS + 1
# the CLIP-ViT path's prompt rows (phase 10b), a phase 9 case
CLIP_PREFILL_ROWS = 609
MMU_QUESTION = "What is in this image?"
MMU_IMAGE = "assets/validation/test_image.png"
WSMM_TOL = 2e-2      # kernel vs plain, max abs error over the output's peak
L2_BYTES = 50e6      # H100 L2: timed weights rotate through twice this
# int8 prefill logits at full width against the unquantized fp32 model: the
# limits of the JAX package's tests/test_int8_decode.py (whose reference is
# the fp32 model too)
INT8_AGREE, INT8_REL = 0.95, 0.05
# the Show-o2 slice: 28 Qwen2.5 + 10 DiT layers, each one kernel 1 launch
# per velocity evaluation, 49 evaluations (50-point Euler)
V2_CONFIG = "configs/showo2_1.5b_demo_432x432.yaml"
V2_QWEN_LAYERS, V2_LAYERS, V2_EVALS, V2_BATCH = 28, 28 + 10, 49, 4
# (label, q heads, kv heads, head dim) of kernels 1 and 6 on the slice
V2_SHAPES = (("Qwen2.5 12/2 D=128", 12, 2, 128), ("DiT 32/8 D=64", 32, 8, 64))
# packed vs dense, one full-width v2 velocity evaluation: max |dv| over the
# dense velocity's peak (phase 13).  The routes round P to bf16 at
# different points through 38 layers; read on an H100 at 700 W: 2.47e-2
# unguided (1.92e-1 with CFG 7.5, which multiplies the difference of the
# two halves by 7.5), 4x above the reading
V2_STEP_TOL = 1e-1
# the v1 modes (phase 14): extrapolation's directions, one generate each
EXTRA_DIRECTIONS = ("up", "down")
# the Show-o2 prefix cache (phase 16): 38 layers x (the prefill + 49
# cached evaluations) kernel 1 launches, and two tile maps a generate (the
# prefill's rows, the fresh rows')
V2_CACHED_LAUNCHES, V2_CACHED_MAPS = V2_LAYERS * (1 + V2_EVALS), 2
# the samplers of phase 17: (sampling_method, points of the time grid)
V2_SAMPLERS = (("dpm-solver", 20), ("heun", 50), ("dopri5", 50))
# dopri5's depth (Qwen, DiT, SigLIP layers; the widths are the slice's) and
# batch 1: on these random bf16 weights with CFG 7.5 it took 1454 velocity
# evaluations (242 steps) at full depth and batch 4, 199 s on an H100
V2_DOPRI5_DEPTH = (4, 2, 4)
# Show-o2 understanding (phases 18, 18b): the v2 config's greedy answers of
# MMU_NEW_TOKENS tokens to MMU_QUESTION; with int8 every forward runs
# kernel 9 on 28 x (qkv, o, gate-up, down) + the tied lm_head
V2_MATMULS = 4 * V2_QWEN_LAYERS + 1
# kernel 9 at Qwen2.5-1.5B's products: name -> (K, N, bias)
V2_INT8_SHAPES = {"qkv": (1536, 2048, True), "o": (1536, 1536, False),
                  "gate-up": (1536, 17920, False),
                  "down": (8960, 1536, False),
                  "lm_head": (1536, 151940, False)}
# the image prompt's rows with the stand-in tokenizer: [bos] + 6 system
# words + "user", [boi], the time token, 729 patches, [eoi] + 5 question
# words + "assistant" (phase 18 asserts them; phase 9 times them)
V2_PROMPT_ROWS = 746
# phase 18's logits: the top-1 agreement of int8 on kernel 9 against the
# int8 weights computed exactly may fall below that of bf16 against fp32 by
# this much.  On the random weights the median top-1 margin is ~0.1 of a
# peak of ~4, so bf16 arithmetic alone agrees with fp32 on ~0.95 of the
# rows and the quantization alone on ~0.88 (read on an H100 80GB HBM3 at
# 700 W: int8 vs the exact int8 model 0.9477, bf16 vs fp32 0.9531, the
# exact int8 model vs fp32 0.8767)
V2_AGREE_SLACK = 0.02
# the video clip: 9 frames of 432x432, 3 latent frames after the VAE's two
# time downsamples
V2_VIDEO_FRAMES, V2_LATENT_FRAMES = 9, 3
# bench.py's t2v rows (bench.py:967-970, driven by :291-333), phases 19 and
# 19b: one prompt (2 rows with the null prompt), Euler over 20 grid points
# (19 velocity evaluations), CFG 5.0; t2v at 2 latent frames (5 pixel
# frames, 1536 rows: the packed route), t2v_long at 9 (33 pixel frames,
# 6656 rows: the streaming route, and the streaming VAE decode)
T2V_STEPS, T2V_CFG = 20, 5.0
T2V_EVALS = T2V_STEPS - 1
T2V_FRAMES = {"t2v": 2, "t2v_long": 9}
T2V_ROUTES = {"t2v": "packed", "t2v_long": "streaming"}
T2V_PHASES = {"t2v": "19", "t2v_long": "19b"}
# kernels 1 and 5 against their plain versions at the t2v rows' lengths,
# beside CARD_TOL's max abs error: the largest over rows and heads of
# ||kernel - plain|| / ||plain|| over the head dim.  A video row averages
# ~S values of V, so its output is ~0.02 in size and a max abs limit of
# 2e-2 cannot see a 64-key tile dropped from it (~8 / sqrt(S) of the row:
# 0.1-0.2 at S = 1536-6656).  Read on an H100 80GB HBM3 at 700 W: 4.5e-3
# to 5.9e-3 for kernels 1 and 5 at both lengths, 0.74 to 1.57 for the
# planted fault (a 64-key tile masked in the reference)
T2V_ROW_TOL = 2e-2
# the streaming against the full-clip VAE decode on the card, fp32 with
# cuDNN's TF32 off: max |d| of pixels in [-1, 1]; the same sums in two
# orders (1e-6 at the CPU tests' tiny size)
VAE_STREAM_TOL = 1e-3
# mixed modality (phase 20): rounds of up to 60 top-k 5 tokens and an image
MIXED_ROUNDS, MIXED_TOKENS = 2, 60
MIXED_PROMPT = "Tell me a short story with pictures."
# v1 long video (phase 21): configs/showo_demo.yaml at 256x256
LVG_BATCH, LVG_FRAMES, LVG_CONTEXT = 2, 3, 2
# cached against uncached latents, streaming against packed latents, after
# 49 Euler steps with CFG 7.5 (phases 16, 17): max |d| over the peak of
# the uncached / packed latents; the same bf16 computation in two tilings
V2_LATENT_TOL = 1e-1
# continuous-batching serving (phases 22 / 22b): bench.py's serve rows
# (bench.py:941-984, driven by :563-760) through the port's servers: slots,
# decode chunk, lookahead (the engine's default) and prompt buckets
SERVE_SLOTS, SERVE_CHUNK, SERVE_LOOKAHEAD = 8, 16, 4
# kernel 9's cases at the engine's rows (phase 9): decode at slots x window
# (8 x 1, and 8 x 3 with 2 drafts), fused admission at slots + 320
SERVING_ROWS = (8, 24, 8 + 320)
SERVE_BUCKETS = (320, 384, 448)
# v1 prompts [mmu][soi] 256 image ids [eoi] 8-63 question ids (bench.py:596
# -605), budgets 16-127; row -> (draft length, requests, sampling: None =
# greedy, else (temperature, top_k, top_p))
SERVE_MMU, SERVE_SOI, SERVE_EOI = 50300, 50296, 50297
SERVE_V1_ROWS = {
    "serve_v1_spec2_int8": (2, 32, None),
    "serve_v1_sampled": (0, 64, (0.9, None, 0.9)),
    "serve_v1_spec2_sampled": (2, 64, (0.9, None, 0.9)),
}
# serve_v2_spec2_int8 (bench.py:704-770): 12 embedding prompts of 24 text
# rows, the time row, 729 image rows and 8-39 question rows, the image span
# (730 rows) at row 25, budgets 16-127, buckets 768 / 832, draft length 2
SERVE_V2_BUCKETS, SERVE_V2_REQUESTS, SERVE_V2_SPEC = (768, 832), 12, 2
SERVE_V2_IMG_START = 25
# kernel 9 launches a decode step: v1 24 x (win, wout) + lm_head; v2 the
# 113 of V2_MATMULS; as many a prefill (the head at its last row only, on
# the gemv) and a fused admission (slots + bucket rows a product)
SERVE_V1_MATMULS, SERVE_V2_MATMULS = MMU_MATMULS, V2_MATMULS
# the teacher-forced check: each request's engine tokens through the
# port's single-request model (prefill, then one cached forward of the
# engine's tokens).  Greedy rows: every engine token's reference logit
# within GREEDY_LOGIT_TOL of that position's largest: 8 bf16 ulps of the
# logits' peak of ~4 on these random weights (kernel 9 runs the prefill
# core at M = 8 / 24 in the engine and at other shapes in the reference,
# so near-ties flip; read on an H100 80GB HBM3 at 700 W: 0.0312 / 0.0469,
# v1 / v2).  Sampled rows: every token inside the reference's nucleus at
# top_p + NUCLEUS_SLACK (the nucleus edge of ~45,000 near-flat tokens moves
# with bf16 noise).  Every request: its lane's cache rows (every layer's K
# and V, prompt and fed tokens) against the reference cache, the largest
# ||engine - ref|| / ||ref|| of a row within CACHE_ROW_TOL (read: 1.4e-2
# v1, 2.8e-2 v2 over ~10^5-10^6 rows; a row of a wrong position or token,
# the planted fault, 1.46)
GREEDY_LOGIT_TOL, NUCLEUS_SLACK, CACHE_ROW_TOL = 0.125, 0.01, 0.1
# the planted fault: the first requests of serve_v1_spec2_int8 with lane 0's
# decode K/V scattered at its length + 1 (a copy of the chunk program)
SERVE_FAULT_REQUESTS = 8


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _ptxas(log: str) -> list:
    """ptxas' registers and spills of each entry function of an nvcc log,
    as 'kernel<template args>: N registers, S bytes spill stores, L bytes
    spill loads', and where ptxas serialized its wgmma instructions
    (warning C7515) 'wgmma serialized'."""
    import re

    serialized = set(re.findall(r"C7515\).*in the function '([^']+)'", log))
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            # mangled template arguments: Li64E an int, Lb1E a bool
            k = re.search(r"([a-z_]*kernel)(I(?:L[ib]\d+E)+E)?", m.group(1))
            args = [v if t == "i" else ("true" if v == "1" else "false")
                    for t, v in re.findall(r"L([ib])(\d+)E",
                                           k.group(2) or "")] if k else []
            name = m.group(1) if k is None else k.group(1) + (
                f"<{', '.join(args)}>" if args else "")
            out.append([name] + (["wgmma serialized (ptxas C7515)"]
                                 if m.group(1) in serialized else []))
        elif name is not None and ("spill" in line or "registers" in line):
            out[-1].append(line.split(":", 1)[-1].strip().split(",")[0]
                           if "registers" in line else
                           line.strip().split(", ", 1)[-1])
    return [f"{o[0]}: " + "; ".join(o[1:]) for o in out]


def _time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(torch, fn, iters: int = 20, attempts: int = 3, counts=None):
    """Mean device time per call of the kernels ``fn`` launches, from
    torch.profiler: without the host's wrapper and launch time, which the
    CUDA-event times of :func:`_time_ms` include.  Every call launches at
    least one kernel, so a trace with fewer device events than calls lost
    some of them (seen on an H100 in runs that had traced a training step
    before): it is taken again, up to ``attempts`` times, and said so;
    then None (not measured).  ``counts``, a list, gets the device launches
    per call of the trace that was kept."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == cuda]
        if len(kernels) >= iters:
            us = sum(e.time_range.end - e.time_range.start for e in kernels)
            if counts is not None:
                counts.append(len(kernels) / iters)
            return us / 1e3 / iters
        print(f"[profiler] {len(kernels)} device events for {iters} calls: "
              f"some were lost; profiling again")
    print(f"[profiler] device events lost in {attempts} traces: not measured")
    return None


def _ms(x) -> str:
    """A time for the log: 'not measured' for None."""
    return "not measured" if x is None else f"{x:.4f} ms"


def _ratio(a, b) -> str:
    return "not measured" if a is None or b is None else f"{a / b:.2f}x"


def _rate(nbytes, ms) -> str:
    return "not measured" if ms is None else f"{nbytes / ms / 1e6:.0f} GB/s"


def _bound(bytes_moved: float, flops: float,
           rate: float = BF16_FLOPS_PER_S) -> dict:
    """The least time of the work on an H100: the larger of its bytes over
    the memory rate and its operations over their peak ``rate`` (the bf16
    tensor-core rate unless given)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _t2i_layout(uni, prompts, num_vq_tokens: int, mask_id: int, device):
    """[cond | uncond] token rows of the t2i layout for the prompts."""
    import numpy as np
    import torch

    img = np.full((BATCH, num_vq_tokens), mask_id, np.int64)
    ids, _ = uni((prompts, img), "t2i_gen")
    unc, _ = uni(([""] * len(prompts), img), "t2i_gen")
    return torch.as_tensor(np.concatenate([ids, unc]), device=device)


def _errors(got, want):
    """(max abs error, relative norm error ||got - want|| / ||want||) of
    two tuples of tensors, each the larger over the tuple."""
    abs_err = rel_err = 0.0
    for g, w in zip(got, want):
        d = g.float() - w.float()
        abs_err = max(abs_err, d.abs().max().item())
        rel_err = max(rel_err, (d.norm() / w.float().norm()).item())
    return abs_err, rel_err


def _check(got, want, grads):
    """(error, tolerance) of the check a kernel's result is held to: the
    max abs error against CARD_TOL, or for gradients the relative norm
    error against GRAD_TOL."""
    abs_err, rel_err = _errors(got, want)
    return (rel_err, GRAD_TOL) if grads else (abs_err, CARD_TOL)


def _compare(torch, label, kern, plain, bound, library=None, phase=3,
             grads=False):
    """Kernel vs plain on the same inputs (one tensor or a tuple of them),
    checked by :func:`_check`, then median times of kernel, plain version
    and the library call, and the bound."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g in got:
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: kernel output not finite")
    abs_err, rel_err = _errors(got, want)
    err, tol = _check(got, want, grads)
    what = "relative norm error" if grads else "max abs error"
    if not err <= tol:
        raise AssertionError(f"{label}: kernel vs plain {what} {err} > {tol}")
    ms, plain_ms = _time_ms(torch, kern), _time_ms(torch, plain)
    lib_ms = _time_ms(torch, library) if library is not None else None
    lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
    print(f"[{phase}] {label} bf16: max_abs_err {abs_err:.3e}, relative norm "
          f"err {rel_err:.3e} (tol {tol:.0e} on the {what}), kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib} (median of "
          f"20); bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    return {"max_abs_err": abs_err, "rel_norm_err": rel_err, "ms": ms,
            "plain_ms": plain_ms, **bound, "library_ms": lib_ms}


def phase_kernels(torch, uni, prompts, cfg, device):
    """Each kernel against its plain version at the main path's shapes;
    returns {route: {"512": result, "256": result}}."""
    import torch.nn.functional as F

    from showo_tpu_torch.models.phi import rope_tables
    from showo_tpu_torch.ops import decode_attention as tda
    from showo_tpu_torch.ops import flash_attention as tfa
    from showo_tpu_torch.ops import fused_decode as tfd
    from showo_tpu_torch.ops import streaming_attention as tsa
    from showo_tpu_torch.ops.masks import omni_mask_predict_next

    sp = uni.sptids
    ids = (sp["<|pad|>"], sp["<|soi|>"], sp["<|eoi|>"])
    hidden = H * D
    out = {route: {} for route in (*KERNELS, "fused_norm")}
    for res, vq_tokens in (("512", 1024), ("256", 256)):
        full = _t2i_layout(uni, prompts, vq_tokens, cfg.mask_token_id, device)
        B, L = full.shape
        Q = L - P
        meta = tfa.metadata_predict_next(full, *ids)
        if not int(meta[1].sum()) > 0:
            raise AssertionError("the t2i layout must be left-padded")
        pos = torch.arange(P, L, device=device)
        # the metadata each forward computes once (models/phi.py attn_step)
        pos_q, seg_q = tfa.q_rows(meta[0], pos, B, Q)
        rows = tfd.fused_rows(meta[0], meta[1], pos, P, B)
        shape = f"B={B} Q={Q} K={L} H={H} D={D}"
        g = torch.Generator(device=device).manual_seed(vq_tokens)
        # the work the mask leaves: 4*D operations per visible (row, key)
        # pair and head (q.k and p.v); metadata bytes beside the tensors
        vis = tfa.visible_mask(*meta, pos_q)
        flops = 4 * D * H * int(vis.sum())
        meta_bytes = 4 * (2 * B * L + 2 * B + 2 * B * Q)
        mask = vis[:, None]

        def randn(*s):
            return torch.randn(*s, generator=g, device=device).bfloat16()

        def sdpa(q4, k4, v4, m=mask, **kw):
            return lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=m, **kw)

        if res == "512":
            # kernel 1 on the wgmma core, on the tile map its forward makes
            # once (models/phi.py attn_step)
            nt = (-(-Q // 64), -(-L // 64))
            tiles, out["tiles"] = _map_check(
                torch, f"kernel 1's tile map {shape} [{B}, {nt[0]}, "
                f"{nt[1] + 1}]", lambda: tfa.rows_tile_map(*meta, pos_q,
                                                           seg_q),
                lambda: tfa.rows_tile_map_plain(*meta, pos_q),
                meta_bytes + B * nt[0] * (nt[1] + 1),
                B * nt[0] * nt[1] * 64 ** 2, 3, flag=True)
            for hkv in (H, H // 4):
                q, k, v = randn(B, Q, H * D), randn(B, L, hkv * D), randn(
                    B, L, hkv * D)
                heads = [t.unflatten(-1, (-1, D)).transpose(1, 2)
                         for t in (q, k, v)]
                kernel1 = (lambda: tfa.omni_attention_packed(
                    q, k, v, *meta, num_heads=H, num_kv_heads=hkv,
                    q_positions=pos_q, seg_q=seg_q, tiles=tiles))
                r = _compare(
                    torch, f"omni_attention_packed {shape} Hkv={hkv}",
                    kernel1,
                    lambda: tfa.omni_attention_packed_plain(
                        q, k, v, *meta, pos_q, num_heads=H,
                        num_kv_heads=hkv, sm_scale=D ** -0.5),
                    _bound(2 * (2 * B * Q * H + 2 * B * L * hkv) * D
                           + meta_bytes, flops),
                    sdpa(*heads, enable_gqa=hkv != H))
                out["packed"].setdefault(res, r)

        # omni (kernel 4, the wgmma core): transposed [B, S, H, D] views,
        # as phi's omni route passes them, on the tile map of kernel 1's
        # kind its forward makes once (models/phi.py attn_step)
        nt = (-(-Q // 64), -(-L // 64))
        map_bytes = B * nt[0] * (nt[1] + 1)
        tiles4, r_map = _map_check(
            torch, f"kernel 4's tile map {shape} [{B}, {nt[0]}, "
            f"{nt[1] + 1}]", lambda: tfa.omni_tile_map(*meta, pos_q, seg_q),
            lambda: tfa.rows_tile_map_plain(*meta, pos_q),
            meta_bytes + map_bytes, B * nt[0] * nt[1] * 64 ** 2, 3,
            flag=True)
        out.setdefault("omni_tiles", r_map)
        q, k, v = (randn(B, n, H, D).transpose(1, 2) for n in (Q, L, L))
        qkv_bytes = 2 * (2 * B * Q * H + 2 * B * L * H) * D
        kernel4 = (lambda: tfa.omni_attention(
            q, k, v, *meta, q_positions=pos_q, seg_q=seg_q, tiles=tiles4))
        r = out["omni"][res] = _compare(
            torch, f"omni_attention {shape}", kernel4,
            lambda: tfa.omni_attention_plain(q, k, v, *meta, pos_q,
                                             sm_scale=D ** -0.5),
            _bound(qkv_bytes + meta_bytes, flops), sdpa(q, k, v))
        if res == "512":
            # kernel 1 on the same memory: [B, S, H, D] is [B, S, H*D]
            packed = [t.transpose(1, 2).flatten(2) for t in (q, k, v)]
            kernel1 = (lambda: tfa.omni_attention_packed(
                *packed, *meta, num_heads=H, q_positions=pos_q,
                seg_q=seg_q, tiles=tiles))
            diff = (kernel4().transpose(1, 2).flatten(2).float()
                    - kernel1().float()).abs().max().item()
            r["kernel1_ms"], r["kernel1_diff"] = _time_ms(torch, kernel1), diff
            print(f"[3] {shape}: kernel 4 {r['ms']:.4f} ms beside kernel 1 "
                  f"on the same memory {r['kernel1_ms']:.4f} ms (median of "
                  f"20); outputs max |difference| {diff:.3e} (0 expected: "
                  f"one function through one core; tol {CARD_TOL:.0e})")
            if not diff <= CARD_TOL:
                raise AssertionError(f"kernel 4 and kernel 1 differ by "
                                     f"{diff}")

        # streaming (kernel 5, the wgmma core): the same views, on the tile
        # map of kernel 1's kind its forward makes once (models/phi.py
        # attn_step); every fresh row of the t2i layout sees its own key,
        # so the library call has no empty row
        tiles5, r_map = _map_check(
            torch, f"kernel 5's tile map {shape} [{B}, {nt[0]}, "
            f"{nt[1] + 1}]", lambda: tsa.streaming_tile_map(*meta, pos_q,
                                                            seg_q),
            lambda: tfa.rows_tile_map_plain(*meta, pos_q),
            meta_bytes + map_bytes, B * nt[0] * nt[1] * 64 ** 2, 3,
            flag=True)
        out.setdefault("streaming_tiles", r_map)
        for hkv in (H, H // 4) if res == "512" else (H,):
            q, k, v = (randn(B, n, h, D).transpose(1, 2)
                       for n, h in ((Q, H), (L, hkv), (L, hkv)))
            kernel5 = (lambda: tsa.omni_attention_streaming(
                q, k, v, *meta, q_positions=pos_q, seg_q=seg_q,
                tiles=tiles5))
            r = _compare(
                torch, f"omni_attention_streaming {shape} Hkv={hkv}",
                kernel5,
                lambda: tsa.omni_attention_streaming_plain(
                    q, k, v, *meta, pos_q, sm_scale=D ** -0.5),
                _bound(2 * (2 * B * Q * H + 2 * B * L * hkv) * D
                       + meta_bytes, flops),
                sdpa(q, k, v, enable_gqa=hkv != H))
            if res == "512":
                # kernel 1 on the same memory: [B, S, H, D] is [B, S, H*D]
                packed = [t.transpose(1, 2).flatten(2) for t in (q, k, v)]
                kernel1 = (lambda: tfa.omni_attention_packed(
                    *packed, *meta, num_heads=H, num_kv_heads=hkv,
                    q_positions=pos_q, seg_q=seg_q, tiles=tiles))
                diff = (kernel5().transpose(1, 2).flatten(2).float()
                        - kernel1().float()).abs().max().item()
                r["kernel1_ms"], r["kernel1_diff"] = (
                    _time_ms(torch, kernel1), diff)
                print(f"[3] {shape} Hkv={hkv}: kernel 5 {r['ms']:.4f} ms "
                      f"beside kernel 1 on the same memory "
                      f"{r['kernel1_ms']:.4f} ms (median of 20); outputs "
                      f"max |difference| {diff:.3e} (tol {CARD_TOL:.0e})")
                if not diff <= CARD_TOL:
                    raise AssertionError(f"kernel 5 and kernel 1 differ by "
                                         f"{diff}")
            out["streaming"].setdefault(res, r)

        # decode (kernel 3, the wgmma core under the bias): the bias as the
        # cached step's strided view of the mask, on its tile map, made
        # once per forward (models/phi.py); the library call takes the bias
        # cast to bf16 (the query's type)
        bias = omni_mask_predict_next(full, *ids, rm_pad_in_image=True)
        bias = bias[:, :, P:, :]
        tiles3, r_map = _map_check(
            torch, f"kernel 3's bias tile map {shape} (row stride {L}) "
            f"[{B}, {nt[0]}, {nt[1] + 1}]", lambda: tda.bias_tile_map(bias),
            lambda: tda.bias_tile_map_plain(bias), 4 * B * Q * L + map_bytes,
            B * Q * L, 3, flag=True)
        out.setdefault("decode_tiles", r_map)
        q, k, v = (randn(B, n, H, D) for n in (Q, L, L))
        out["decode"][res] = _compare(
            torch, f"decode_attention {shape} (bias view, row stride {L})",
            lambda: tda.decode_attention(q, k, v, bias, tiles=tiles3),
            lambda: tda.decode_attention_plain(q, k, v, bias),
            _bound(qkv_bytes + 4 * B * Q * L,
                   4 * D * H * int((bias == 0).sum())),
            sdpa(*(t.transpose(1, 2) for t in (q, k, v)),
                 m=bias.to(torch.bfloat16)))

        # fused (kernel 2): y a full-width win output, ck/cv views of a
        # cache; the LayerNorm + RoPE pass, then the core over [cache |
        # fresh] keys at pos_k on the map of those keys its forward makes
        # once (models/phi.py attn_step)
        y = randn(B, Q, 3 * hidden + cfg.llm.intermediate_size)
        cache = randn(2, B, L, H, D)
        ln = [(1 + 0.1 * torch.randn(D, generator=g, device=device))
              .bfloat16(), (0.1 * torch.randn(D, generator=g, device=device))
              .bfloat16()]
        cos, sin = rope_tables(pos, 32, cfg.llm.rope_theta)
        ck, cv = cache[0, :, :P].flatten(2), cache[1, :, :P].flatten(2)
        args = (y, ck, cv, ln, ln, cos, sin)
        kw = dict(hidden=hidden, num_heads=H, rotary_dim=32, eps=1e-5)
        tiles2, r_map = _map_check(
            torch, f"kernel 2's tile map {shape} (keys at pos_k) [{B}, "
            f"{nt[0]}, {nt[1] + 1}]",
            lambda: tfd.fused_tile_map(rows, meta[2], meta[3]),
            lambda: tfa.rows_tile_map_plain(
                rows[3], rows[4], meta[2], meta[3], rows[0], pos_k=rows[2],
                seg_q=rows[1]),
            meta_bytes + 4 * L + map_bytes, B * nt[0] * nt[1] * 64 ** 2, 3,
            flag=True)
        out.setdefault("fused_tiles", r_map)
        # bytes of the function: y's q/k/v columns, the prefix K/V, out,
        # cos/sin, norms; of the pass: y's q/k columns read, qn / kn
        # written; of the core: qn / kn, y's v columns, the prefix K/V,
        # out; operations: the attention products (LayerNorm and RoPE add
        # ~1%)
        io = 2 * B * Q * hidden
        small = 2 * Q * 32 * 4 + 4 * D * 2
        whole = _compare(
            torch, f"fused_decode_attention {shape} (y row stride "
            f"{y.shape[-1]}), both launches",
            lambda: tfd.fused_decode_attention(*args, *meta, pos, rows=rows,
                                               tiles=tiles2, **kw),
            lambda: tfd.fused_decode_attention_plain(
                *args, meta[2], meta[3], rows, sm_scale=D ** -0.5,
                softmax_dtype=torch.float32, **kw),
            _bound(4 * io + 2 * 2 * B * P * hidden + small + meta_bytes,
                   flops))
        qn, kn = tfd.norm_rope(y, ln, ln, cos, sin, **kw)
        norm = out["fused_norm"][res] = _norm_rope_check(
            torch, shape, lambda: tfd.norm_rope(y, ln, ln, cos, sin, **kw),
            lambda: tfd.norm_rope_plain(y, ln, ln, cos, sin, **kw),
            _bound(4 * io + small, 0))
        part = dict(hidden=hidden, num_heads=H)
        keys = [torch.cat([ck, kn], 1),
                torch.cat([cv, y[..., 2 * hidden:3 * hidden]], 1)]
        vis2 = tfa.visible_mask(rows[3], rows[4], meta[2], meta[3], rows[0],
                                pos_k=rows[2], seg_q=rows[1])
        r = out["fused"][res] = _compare(
            torch, f"fused_decode core {shape} (keys at pos_k, split at "
            f"P={P})",
            lambda: tfd.fused_attend(qn, kn, y, ck, cv, meta[2], meta[3],
                                     rows, tiles2, **part),
            lambda: tfd.fused_attend_plain(qn, kn, y, ck, cv, meta[2],
                                           meta[3], rows, sm_scale=D ** -0.5,
                                           **part),
            _bound(3 * io + 2 * 2 * B * P * hidden + meta_bytes + 4 * L,
                   flops),
            sdpa(*(t.unflatten(-1, (H, D)).transpose(1, 2)
                   for t in [qn] + keys), m=vis2[:, None]))
        r["whole"] = whole
        print(f"[3] {shape}: kernel 2 {whole['ms']:.4f} ms (both launches) "
              f"= the pass {norm['ms']:.4f} ms + the core {r['ms']:.4f} ms "
              f"(library on the core's part {_ms(r['library_ms'])}); bound "
              f"{whole['bound_ms']:.4f} ms ({whole['bound_by']}), of the "
              f"two launches {norm['bound_ms'] + r['bound_ms']:.4f} ms")
    return out


def _norm_rope_check(torch, shape, kern, plain, bound):
    """Kernel 2's LayerNorm + RoPE pass against its plain twin: every value
    within 2 bf16 ulps of its head row's peak (a normed value is rounded
    to bf16 and the kernel's rsqrt is the card's approximate one, so a
    value may move by an ulp, and a roped value that cancels by an ulp of
    its terms), timed as :func:`_compare` times; no library call does
    LayerNorm + RoPE."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    ulps = abs_err = 0.0
    for g, w in zip(got, want):
        if not (torch.isfinite(g).all() and g.is_contiguous()):
            raise AssertionError(f"{shape}: the LN + RoPE pass's output is "
                                 f"not finite or not contiguous")
        peak = w.float().unflatten(-1, (-1, D)).abs().amax(-1, keepdim=True)
        ulp = torch.exp2(torch.floor(torch.log2(peak.clamp_min(2.0 ** -100)))
                         - 7)
        d = (g.float() - w.float()).unflatten(-1, (-1, D)).abs()
        ulps = max(ulps, (d / ulp).max().item())
        abs_err = max(abs_err, d.max().item())
    if not ulps <= 2:
        raise AssertionError(f"{shape}: the LN + RoPE pass differs from its "
                             f"plain twin by {ulps} ulps of a head row's peak")
    ms, plain_ms = _time_ms(torch, kern), _time_ms(torch, plain)
    print(f"[3] {shape}: kernel 2's LN + RoPE pass: max {ulps:.2f} bf16 ulps "
          f"of a head row's peak (max abs {abs_err:.3e}; limit 2 ulps), "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20); "
          f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
          f"{_rate(bound['bound_ms'] * HBM_BYTES_PER_S / 1e3, ms)}")
    return {"max_abs_err": abs_err, "max_ulps": ulps, "ms": ms,
            "plain_ms": plain_ms, **bound, "library_ms": None}


def _ragged_meta(torch, device, B=4, S=200):
    """Metadata with an image span, left pads and last_pad = 5, so rows
    6..9 see no key (all their columns are pads they may not see)."""
    seg = torch.zeros((B, S), dtype=torch.int32, device=device)
    seg[:, 40:150] = 1
    pad = torch.zeros_like(seg)
    pad[:, :10] = 1
    last_pad = torch.full((B,), 5, dtype=torch.int32, device=device)
    return seg, pad, last_pad, torch.zeros_like(last_pad)


def _planted_faults(shape, plain, v, wrong_v, m, phase):
    """The trainable kernels' checks on two faults planted in their plain
    versions, as a kernel would make them: V read from the neighbouring kv
    head (``wrong_v``), and keys 64..127 (the second K tile) dropped for
    every row past last_pad (they are marked as pads).  ``plain`` maps
    forward, dq and dk/dv to (fn(v, metadata), grads).  Each faulty result
    is held to the correct plain result by :func:`_check`; each must fail
    it, or the check could not tell such a kernel from a right one."""
    pad = m[1].clone()
    pad[:, 64:128] = 1
    faults = {"V of the wrong kv head": (wrong_v, m),
              "K tile 64..127 dropped": (v, (m[0], pad, *m[2:]))}
    readings = []
    for fault, (v_f, m_f) in faults.items():
        for name, (fn, grads) in plain.items():
            want, got = fn(v, m), fn(v_f, m_f)
            if not isinstance(got, tuple):
                got, want = (got,), (want,)
            err, tol = _check(got, want, grads)
            readings.append(f"{fault}, {name} {err:.3e} (tol {tol:.0e})")
            if not err > tol:
                raise AssertionError(f"{shape}: planted fault '{fault}' in "
                                     f"{name} passes the check: {err} <= "
                                     f"{tol}")
            del want, got
    print(f"[{phase}] {shape}: planted faults, each failing the check: "
          + "; ".join(readings))


def _kernel_set(torch, kernel, hkv, H=H, D=D):
    """The wrappers, plain versions, tile map (counter, kernel, plain) and
    layout of one trainable kernel set with ``H`` q and ``hkv`` kv heads
    of ``D``: kernel 7 on the packed [B, S, n*D] layout, or kernel 8 on
    head-major views of [B, S, n, D] tensors (phi's and Qwen's layout)."""
    import functools

    from showo_tpu_torch.ops import packed_attention_grad as tpag
    from showo_tpu_torch.ops import streaming_attention_grad as tsag

    if kernel == 7:
        kw = dict(num_heads=H, num_kv_heads=hkv, sm_scale=D ** -0.5)
        fns = (tpag.packed_trainable_fwd, tpag.packed_trainable_dq,
               tpag.packed_trainable_dkv, tpag.packed_trainable_fwd_plain,
               tpag.packed_trainable_dq_plain, tpag.packed_trainable_dkv_plain)
        ks = dict(
            counters=list(TRAIN_KERNELS)[:3], lse_empty=tpag.LSE_EMPTY,
            tiles=(tpag.TILES_KERNEL, tpag.tile_map, tpag.tile_map_plain),
            tensor=lambda g, B, S, n: torch.randn(
                B, S, n * D, generator=g, device="cuda").bfloat16(),
            heads=lambda t: t.unflatten(-1, (-1, D)).transpose(1, 2),
            delta=lambda out, dout: tpag.attention_delta(out, dout, H),
            wrong_v=lambda v: v.view(*v.shape[:2], hkv, D).roll(
                1, dims=2).reshape(v.shape))
    else:
        kw = dict(sm_scale=D ** -0.5)
        fns = (tsag.streaming_trainable_fwd, tsag.streaming_trainable_dq,
               tsag.streaming_trainable_dkv, tsag.trainable_fwd_plain,
               tsag.trainable_dq_plain, tsag.trainable_dkv_plain)
        ks = dict(
            counters=list(STREAM_TRAIN_KERNELS)[:3], lse_empty=tsag.LSE_EMPTY,
            tiles=(tsag.TILES_KERNEL, tsag.tile_map, tsag.tile_map_plain),
            tensor=lambda g, B, S, n: torch.randn(
                B, S, n, D, generator=g, device="cuda").bfloat16()
            .transpose(1, 2),
            heads=lambda t: t, delta=tsag.attention_delta,
            wrong_v=lambda v: v.roll(1, dims=1))
    ks.update({name: functools.partial(fn, **kw) for name, fn in zip(
        ("fwd", "dq", "dkv", "fwd_plain", "dq_plain", "dkv_plain"), fns)})
    return ks


def phase_train_kernels(torch, meta, kernel, label, phase):
    """A trainable kernel set (kernel 7 or 8) against its plain versions at
    a training step's shape (``meta``, the metadata of the trainer's fused
    batch), a GQA case and a ragged S with rows that see no key: its tile
    map against the plain one, the forward, dq and dk/dv on that map and
    bit-stable over two launches; then the planted faults.  At the step's
    shape kernel 8 is timed beside kernel 7's cores on the same memory
    (past kernel 7's budget).  Returns {counter name: result} of the first
    case."""
    import torch.nn.functional as F

    from showo_tpu_torch.ops import streaming_attention_grad as tsag

    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(6 if kernel == 7 else 8)
    cases = [(label, meta, H), (f"{label} GQA", meta, H // 4),
             ("ragged, rows with no visible key",
              _ragged_meta(torch, device), H)]
    results = {}
    for case, m, hkv in cases:
        ks = _kernel_set(torch, kernel, hkv)
        B, S = m[0].shape
        vis = tsag.self_visible(*m)
        empty = int((~vis.any(-1)).sum())
        n_vis = int(vis.sum())
        shape = f"{case}: B={B} S={S} H={H} Hkv={hkv} D={D}"
        if case == label:
            print(f"[{phase}] the {label} fused batch {(B, S)}: {empty} rows "
                  f"that see no key; {n_vis} visible (row, key) pairs of "
                  f"{B * S * S} ({n_vis / (B * S * S):.4f})")
        q, k, v, dout = (ks["tensor"](g, B, S, n) for n in (H, hkv, hkv, H))
        # the kernels read a tile map, made once per forward
        tiles, tiles_result = _tile_map_check(torch, ks, m, shape, phase)
        bwd = {"tiles": tiles}
        out, lse = ks["fwd"](q, k, v, *m, **bwd)
        lse_err = (lse - ks["fwd_plain"](q, k, v, *m)[1]).abs().max().item()
        if not lse_err <= CARD_TOL or (
                (lse == ks["lse_empty"]).sum() != empty * H):
            raise AssertionError(f"{shape}: lse err {lse_err} or rows with "
                                 f"no visible key not marked")
        delta = ks["delta"](out, dout)
        args = (q, k, v, dout, lse, delta, *m)
        _bit_stable(torch, ks, args, tiles, shape, phase)
        # bytes: each input read once and each output written once;
        # operations: 2*D per visible pair, head and product (forward 2
        # products, dq 3, dk/dv 4)
        tensor = 2 * B * S * D
        meta_bytes = 4 * (2 * B * S + 2 * B)
        rows_bytes = 4 * B * H * S
        lib = {}
        if case == label and not empty:
            heads = [ks["heads"](t).detach().requires_grad_(True)
                     for t in (q, k, v)]
            dout4 = ks["heads"](dout)
            mask = vis[:, None]
            o4 = F.scaled_dot_product_attention(*heads, attn_mask=mask)
            lib = {
                "fwd": lambda: F.scaled_dot_product_attention(
                    *heads, attn_mask=mask),
                "bwd": lambda: torch.autograd.grad(o4, heads, dout4,
                                                   retain_graph=True),
            }
            fb = _time_ms(torch, lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(*heads, attn_mask=mask),
                heads, dout4))
            print(f"[{phase}] {shape}: scaled_dot_product_attention with the "
                  f"boolean mask, forward + backward {fb:.4f} ms (median "
                  f"of 20)")
        bounds = {
            "fwd": _bound((2 * H + 2 * hkv) * tensor + rows_bytes
                          + meta_bytes, 4 * D * H * n_vis),
            "dq": _bound((3 * H + 2 * hkv) * tensor + 2 * rows_bytes
                         + meta_bytes, 6 * D * H * n_vis),
            "dkv": _bound((2 * H + 4 * hkv) * tensor + 2 * rows_bytes
                          + meta_bytes, 8 * D * H * n_vis)}

        def compare(part):
            what = {"fwd": "forward", "dq": "dq", "dkv": "dk/dv"}[part]
            call = ((lambda: ks["fwd"](q, k, v, *m, **bwd)[0])
                    if part == "fwd" else (lambda: ks[part](*args, **bwd)))
            plain = ((lambda: ks["fwd_plain"](q, k, v, *m)[0])
                     if part == "fwd" else (lambda: ks[f"{part}_plain"](
                         *args)))
            return _compare(
                torch, f"trainable {what} {shape}", call, plain,
                bounds[part], lib.get("fwd" if part == "fwd" else "bwd"),
                phase=phase, grads=part != "fwd")

        r = {name: compare(part)
             for name, part in zip(ks["counters"], ("fwd", "dq", "dkv"))}
        r[ks["tiles"][0]] = tiles_result
        lib = heads = o4 = None
        print(f"[{phase}] {shape}: lse max_abs_err {lse_err:.3e}; {empty} "
              f"rows with no visible key (out 0, lse {ks['lse_empty']:g} in "
              f"every head); library call of dq and dk/dv: one backward of "
              f"scaled_dot_product_attention (dq, dk, dv together)")
        _planted_faults(shape, {
            "forward": (lambda v_, m_: ks["fwd_plain"](q, k, v_, *m_)[0],
                        False),
            "dq": (lambda v_, m_: ks["dq_plain"](q, k, v_, *args[3:6], *m_),
                   True),
            "dk/dv": (lambda v_, m_: ks["dkv_plain"](q, k, v_, *args[3:6],
                                                     *m_), True),
        }, v, ks["wrong_v"](v), m, phase)
        if kernel == 8 and case == label:
            _kernel7_beside_kernel8(torch, q, k, v, dout, m, hkv, phase)
        results.setdefault(case, r)
    return results[label]


def _tile_map_check(torch, ks, m, shape, phase):
    """A kernel set's tile map of metadata ``m`` against its plain version;
    returns (the map, its result)."""
    B, S = m[0].shape
    nt = -(-S // 64)
    _, make, plain = ks["tiles"]
    return _map_check(
        torch, f"{shape}: tile map [{B}, {nt}, {nt}]", lambda: make(*m),
        lambda: plain(*m), 4 * (2 * B * S + 2 * B) + B * nt * nt,
        B * (nt * 64) ** 2, phase)


def _map_check(torch, label, make, plain, nbytes, pairs, phase,
               flag=False):
    """A tile map kernel (``make``) against its plain version, byte for
    byte, timed; ``flag``: the map's last column flags q tiles with a row
    that sees no key.  Bound: ``nbytes`` (the metadata read once, the map
    written once) or the predicate's ~8 integer operations per (row, key)
    pair of the padded tiles (``pairs``) at the rate of the CUDA cores (no
    tensor-core type applies).  Returns (the map, its result)."""
    tiles, want = make(), plain()
    torch.cuda.synchronize()
    if not torch.equal(tiles, want):
        raise AssertionError(f"{label}: differs from its plain version in "
                             f"{int((tiles != want).sum())} entries")
    cls = tiles[..., :-1] if flag else tiles
    classes = [int((cls == c).sum()) for c in (0, 1, 3)]
    bound = _bound(nbytes, 8 * pairs, FP32_OPS_PER_S)
    ms, plain_ms = _time_ms(torch, make), _time_ms(torch, plain)
    flags = (f", q tiles with a row that sees no key "
             f"{int(tiles[..., -1].sum())}" if flag else "")
    print(f"[{phase}] {label} equal to its plain version; pairs of 64-row "
          f"tiles skipped / masked / all visible {classes[0]} / {classes[1]}"
          f" / {classes[2]}{flags}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (median of 20); bound {bound['bound_ms']:.4f} "
          f"ms ({bound['bound_by']})")
    return tiles, {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                   **bound, "library_ms": None, "tile_classes": classes}


def _bit_stable(torch, ks, args, tiles, shape, phase):
    """A kernel set's forward, dq and dk/dv give the same bits over two
    launches on one tile map (no atomics, a fixed order of the sums)."""
    q, k, v, m = *args[:3], args[6:]
    runs = [(*ks["fwd"](q, k, v, *m, tiles=tiles),
             ks["dq"](*args, tiles=tiles), *ks["dkv"](*args, tiles=tiles))
            for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError(f"{shape}: out / lse / dq / dk / dv differ "
                             f"over two launches")
    print(f"[{phase}] {shape}: out, lse, dq, dk and dv bit-identical over "
          f"two launches on one tile map")


def _kernel7_beside_kernel8(torch, q, k, v, dout, m, hkv, phase):
    """Kernel 7 (the packed trainable kernels, past their TPU budget here)
    on the same memory as kernel 8's head-major views: its wgmma cores
    beside kernel 8's (the same cores on other strides).  Each kernel timed
    (CUDA events; on a tile map made once), and each autograd Function
    (forward + backward, which makes its own map); their forward outputs
    must agree within CARD_TOL."""
    from showo_tpu_torch.ops import packed_attention_grad as tpag
    from showo_tpu_torch.ops import streaming_attention_grad as tsag

    k7, k8 = _kernel_set(torch, 7, hkv), _kernel_set(torch, 8, hkv)
    packed = [t.transpose(1, 2).flatten(2) for t in (q, k, v, dout)]
    times, outs = {}, []
    for name, ks, (q_, k_, v_, d_), fn, kw in (
            ("kernel 7", k7, packed, lambda *t: tpag.PackedTrainableAttention
             .apply(*t, *m, H, hkv, D ** -0.5), {"tiles": tpag.tile_map(*m)}),
            ("kernel 8", k8, (q, k, v, dout), lambda *t: tsag
             .StreamingTrainableAttention.apply(*t, *m, D ** -0.5),
             {"tiles": tsag.tile_map(*m)})):
        out, lse = ks["fwd"](q_, k_, v_, *m, **kw)
        outs.append(out if ks is k7 else out.transpose(1, 2).flatten(2))
        a = (q_, k_, v_, d_, lse, ks["delta"](out, d_), *m)
        leaves = [t.detach().requires_grad_(True) for t in (q_, k_, v_)]
        times[name] = [
            _time_ms(torch, lambda: ks["fwd"](q_, k_, v_, *m, **kw)),
            _time_ms(torch, lambda: ks["dq"](*a, **kw)),
            _time_ms(torch, lambda: ks["dkv"](*a, **kw)),
            _time_ms(torch, lambda: torch.autograd.grad(fn(*leaves), leaves,
                                                        d_))]
    diff = (outs[0].float() - outs[1].float()).abs().max().item()
    print(f"[{phase}] the same shape and memory (kernel 7 is past its TPU "
          f"budget here; nothing routes by this): "
          + "; ".join(f"{name} forward {t[0]:.4f}, dq {t[1]:.4f}, dk/dv "
                      f"{t[2]:.4f}, autograd Function forward + backward "
                      f"{t[3]:.4f} ms" for name, t in times.items())
          + f" (medians of 20); forward outputs max |difference| {diff:.3e}")
    if not diff <= CARD_TOL:
        raise AssertionError(f"kernel 7's and kernel 8's forwards differ by "
                             f"{diff} > {CARD_TOL}")


def phase_train(torch, cuda_build, trainer, batch, noise, smi, label,
                kernels, phase):
    """A training slice: one step, then TRAIN_STEPS steps on the same
    batch and draws with the launch counts set to 0 before them; the
    trainable route's ``kernels`` launch their counts per step, every other
    kernel none."""
    m = trainer.train_step(*batch, noise=noise)
    losses = [float(m["loss"])]
    want = {name: 0 for name in COUNTERS}
    want.update({name: n * TRAIN_STEPS for name, (_, n) in kernels.items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    walls, metrics = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = trainer.train_step(*batch, noise=noise)
        losses.append(float(m["loss"]))            # waits for the step
        walls.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    counts = {name: cuda_build.launches[name] for name in want}
    if counts != want:
        raise AssertionError(f"training launches over {TRAIN_STEPS} steps "
                             f"{counts}, want {want}")
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    wall = statistics.median(walls)
    rows = sum(trainer.step_fn.sizes)
    last = metrics[-1]
    tokens = trainer.tc.max_seq_length + 3 + trainer.cfg.num_vq_tokens
    before = (f" (last recorded before this backward: {STEP512_BEFORE})"
              if label == "512x512" else "")
    print(f"[{phase}] training slice {label}, route trainable, {rows} rows "
          f"x {tokens} tokens, bf16 autocast, remat "
          f"{trainer.tc.remat}, clip {trainer.tc.max_grad_norm}: launches "
          f"per step {_per_step(counts)}, 0 of the other kernels; losses "
          f"{[round(x, 4) for x in losses]}; "
          f"last step t2i {last['loss_t2i']:.4f} lm {last['loss_lm']:.4f} "
          f"mmu {last['loss_mmu']:.4f} grad_norm {last['grad_norm']:.4f}; "
          f"step {wall:.4f} s{before} (median of {TRAIN_STEPS}: "
          f"{', '.join(f'{w:.4f}' for w in walls)}), "
          f"{rows / wall:.2f} samples/s, peak memory allocated "
          f"{peak:.2f} GiB on {smi}")
    return {name: counts[name] for name in kernels}


def _per_step(counts, steps: int = TRAIN_STEPS) -> dict:
    return {n: c // steps for n, c in counts.items() if c}


def phase_train_parity(torch, trainer, batch, noise, phase, loss_tol,
                       norm_tol):
    """One full-width step's losses and grad norm on ``trainable`` and on
    ``dense``: the same weights, host batch and corruption draws."""
    from showo_tpu_torch.training.train_step import global_norm

    inputs = trainer.host_batch(*batch)
    dense = copy.copy(trainer.step_fn)
    dense.tc = dataclasses.replace(trainer.tc, attn_impl="dense")
    got, ids = {}, {}
    for route, step in (("trainable", trainer.step_fn), ("dense", dense)):
        prepared = step.prepare(*inputs, noise=noise)
        total, parts, grads = step.loss_and_grads(prepared)
        got[route] = [float(x) for x in (total, *parts, global_norm(grads))]
        ids[route] = prepared.input_ids
        del grads, prepared
    if not torch.equal(ids["trainable"], ids["dense"]):
        raise AssertionError("the two routes assembled different batches")
    names = ("loss", "loss_t2i", "loss_lm", "loss_mmu", "grad_norm")
    rel = {n: abs(a - b) / abs(b) for n, a, b in
           zip(names, got["trainable"], got["dense"])}
    print(f"[{phase}] training step parity, trainable vs dense (24 layers, "
          f"{tuple(ids['dense'].shape)}, bf16 autocast): "
          + ", ".join(f"{n} {a:.5f} vs {b:.5f} (rel {rel[n]:.2e})"
                      for n, a, b in zip(names, got["trainable"],
                                         got["dense"]))
          + f"; tol {loss_tol} (losses), {norm_tol} (grad norm)")
    bad = [n for n in names
           if rel[n] > (norm_tol if n == "grad_norm" else loss_tol)]
    if bad:
        raise AssertionError(f"trainable vs dense differ in {bad}: {rel}")


def phase_slice(torch, np, inference_t2i, cuda_build, config, prompts,
                route, smi):
    """The 512x512 pipeline on ``route``: launch counts over one generate
    call, output checks, warm wall time.  Returns (pipeline, launches)."""
    t0 = time.perf_counter()
    pipe = inference_t2i.build_pipeline(config, device=torch.device("cuda"),
                                        attn_impl=route)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = pipe.cfg
    if not (pipe.attn_route == route and cfg.llm.num_layers == NUM_LAYERS
            and cfg.llm.hidden_size == 2048 and cfg.num_vq_tokens == 1024):
        raise AssertionError(f"not the full-width 512x512 path on {route}: "
                             f"{pipe.attn_route}, {cfg}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    pipe.generate(prompts, gen)                       # warm-up
    want = _route_want(route)
    cuda_build.launches.clear()
    images = pipe.generate(prompts, gen)
    counts = {name: cuda_build.launches[name] for name in want}
    if counts != want:
        raise AssertionError(f"{route}: kernel launches in one generate "
                             f"call {counts}, want {want}")
    if images.shape != (BATCH, 512, 512, 3) or not np.isfinite(images).all():
        raise AssertionError(f"{route}: images {images.shape} or non-finite")
    if images.min() < -1.0 or images.max() > 1.0:
        raise AssertionError(f"{route}: images outside [-1, 1]")

    walls = []
    for _ in range(3):
        before = dict(cuda_build.launches)
        t0 = time.perf_counter()
        pipe.generate(prompts, gen)
        walls.append(time.perf_counter() - t0)
        if {n: cuda_build.launches[n] - before.get(n, 0)
                for n in want} != want:
            raise AssertionError(f"{route}: launch counts changed")
    codes = pipe.generate_codes(prompts, gen)
    if not (int(codes.min()) >= 0 and int(codes.max()) < cfg.codebook_size
            and tuple(codes.shape) == (BATCH, 1024)):
        raise AssertionError(f"{route}: codes out of range "
                             f"{tuple(codes.shape)}")
    wall = statistics.median(walls)
    core = (f" (all on the wgmma core, reading "
            f"{counts[ROUTE_TILES[route]]} tile maps, one a forward"
            + (f", each after its LN + RoPE pass ({counts[FUSED_NORM]})"
               if route == "fused" else "") + ")")
    print(f"[4] slice t2i 512x512 route {route}, {TIMESTEPS} steps, CFG "
          f"1.75, batch {BATCH}, bf16, random weights (setup {setup_s:.1f} "
          f"s): launches per generate {counts[KERNELS[route][0]]} = "
          f"{NUM_LAYERS} x {TIMESTEPS} of {KERNELS[route][0]}{core}, 0 of "
          f"the others; images {images.shape} finite in [-1, 1]; warm wall "
          f"{wall:.4f} s/batch (median of 3: "
          f"{', '.join(f'{w:.4f}' for w in walls)}), "
          f"{BATCH * 60.0 / wall:.2f} images/min on {smi}")
    return pipe, {n: c for n, c in counts.items() if c}


def phase_step_parity(torch, pipe, prompts, device):
    """One full-width cached step per kernel route against dense masked
    attention, on the same weights and inputs (half the image tokens
    known)."""
    from showo_tpu_torch.models.phi import KVCache
    from showo_tpu_torch.ops.flash_attention import metadata_predict_next
    from showo_tpu_torch.ops.masks import omni_mask_predict_next

    cfg, sp = pipe.cfg, pipe.uni_prompting.sptids
    full = _t2i_layout(pipe.uni_prompting, prompts, cfg.num_vq_tokens,
                       cfg.mask_token_id, device)
    B, L = full.shape
    g = torch.Generator(device=device).manual_seed(5)
    known = torch.rand(B, cfg.num_vq_tokens, generator=g, device=device) < 0.5
    codes = torch.randint(0, cfg.codebook_size, (B, cfg.num_vq_tokens),
                          generator=g, device=device) + cfg.codebook_offset
    full[:, P + 1:L - 1] = torch.where(known, codes, full[:, P + 1:L - 1])
    ids = (sp["<|pad|>"], sp["<|soi|>"], sp["<|eoi|>"])
    bias = omni_mask_predict_next(full, *ids, rm_pad_in_image=True)
    meta = metadata_predict_next(full, *ids)
    phi = pipe.model.showo
    emb = phi.model.embed_tokens.weight
    cache = KVCache.zeros(cfg.llm, B, L, dtype=emb.dtype, device=device)
    head = (1, 1 + cfg.num_vq_tokens, cfg.codebook_offset,
            cfg.codebook_offset + cfg.codebook_size)
    step = dict(input_ids=full[:, P:], attention_bias=bias[:, :, P:],
                cache=cache, lm_head_slice=head, static_prefix_len=P)
    with torch.no_grad():
        phi(input_ids=full[:, :P], attention_bias=bias[:, :, :P], cache=cache)
        dense, _ = phi(attn_meta=None, **step)
        for route in KERNELS:
            kern, _ = phi(attn_meta=(route,) + meta, **step)
            diff = (kern.float() - dense.float()).abs().max().item()
            scale = dense.float().abs().max().item()
            agree = (kern.argmax(-1) == dense.argmax(-1)).float().mean().item()
            print(f"[5] step parity route {route} (24 layers, B={B}, "
                  f"Q={L - P}, bf16): max abs logit diff vs dense "
                  f"{diff:.4e} (tol {STEP_TOL}; max |logit| {scale:.3f}; "
                  f"argmax agreement {agree:.4f})")
            if not diff <= STEP_TOL:
                raise AssertionError(f"{route}: step logits differ by {diff}"
                                     f" > {STEP_TOL}")


def _trainer(torch, build_trainer, train_batch, config, path, rows, phase):
    """A full-width trainer on the ``trainable`` route, its seeded batch
    and draws, and the attention metadata of its fused batch (checked to
    be ``rows`` = (rows, tokens))."""
    t0 = time.perf_counter()
    trainer = build_trainer(config, torch.device("cuda"),
                            attn_impl="trainable")
    batch, noise = train_batch(trainer)
    prepared = trainer.step_fn.prepare(*trainer.host_batch(*batch),
                                       noise=noise)
    torch.cuda.synchronize()
    lc = trainer.cfg.llm
    if not (lc.num_layers == NUM_LAYERS and lc.hidden_size == 2048
            and lc.num_heads == H and tuple(prepared.input_ids.shape) == rows
            and trainer.tc.remat == "full"):
        raise AssertionError(f"not the full-width trainer of {path}: {lc}, "
                             f"{tuple(prepared.input_ids.shape)}")
    print(f"[{phase}] trainer built from {path} (warmup 0) in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{sum(p.numel() for p in trainer.model.parameters())} trainable "
          f"parameters, fused batch {tuple(prepared.input_ids.shape)}, "
          f"clip {trainer.tc.max_grad_norm}")
    return trainer, batch, noise, prepared.attn_meta[1:]


def _rotation(copies):
    """A callable that returns the next of ``copies`` in turn."""
    state = {"i": -1}

    def nxt():
        state["i"] = (state["i"] + 1) % len(copies)
        return copies[state["i"]]
    return nxt


@contextlib.contextmanager
def _first_mma_kernel():
    """The int8 / int4 wrapper with the first mma kernel in the prefill
    kernel's place (its core choice patched), for measurements beside it
    on the same inputs."""
    from showo_tpu_torch.ops import int8_matmul as ti8

    choose = ti8.WeightStream.core
    ti8.WeightStream.core = lambda self, x: (
        "mma" if choose(self, x) == "prefill" else choose(self, x))
    try:
        yield
    finally:
        ti8.WeightStream.core = choose


def _wsmm_case(torch, cuda_build, label, M, K, N, int4, seed, bias=False,
               beside=True):
    """One weight-streaming product against its plain version: the error
    (max abs over the plain output's peak), a planted fault (each column
    scaled by its neighbour's scale) that must fail the same check, median
    times of kernel, plain version, ``torch.matmul`` on dequantized bf16
    weights (the library) and, with ``beside``, the eager
    dequantize-then-matmul, and the bound.  ``bias``: a bf16 bias added
    by every call (the library's after its product).  The weights rotate
    through copies that exceed the L2 twice, as
    the layers of a decode step do (each reads other weights).  The core
    of :func:`select_core` must be the one that ran (the gemv at decode
    rows, the source's prefill kernel above), two calls must give the same
    bits (split-K), and the device launches a product are read from the
    trace.  Above the decode rows and with ``beside`` the first mma kernel
    (:func:`_first_mma_kernel`) is checked and timed beside the prefill
    kernel on the same inputs; without ``beside`` the plain version's
    device time is read instead of the eager one's."""
    from showo_tpu_torch.ops import int4_matmul as ti4
    from showo_tpu_torch.ops import int8_matmul as ti8

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = K // 2 if int4 else K
    padded = -(-N // 16) * 16            # Int8Linear's 16-byte row padding
    n_copies = max(1, -(-int(2 * L2_BYTES) // (rows * N)))
    ws = [torch.randint(-128 if int4 else -127, 128, (rows, padded),
                        generator=g, device=dev, dtype=torch.int8)[:, :N]
          for _ in range(n_copies)]
    x = torch.randn(M, K, generator=g, device=dev).bfloat16()
    s = (torch.rand(1, N, generator=g, device=dev) * 0.01 + 1e-3).bfloat16()
    b = (torch.randn(padded, generator=g, device=dev).bfloat16()[:N]
         if bias else None)
    if int4:
        kern, plain = ti4.pallas_nib_matmul, ti4.nib_matmul_plain
        widen = lambda w: torch.cat(ti4.unpack_nibbles(w)).to(torch.bfloat16)
    else:
        kern, plain = ti8.pallas_i8_matmul, ti8.i8_matmul_plain
        widen = lambda w: w.to(torch.bfloat16)
    prefill = M > ti8.GEMV_MAX_M
    source = "int4_matmul" if int4 else "int8_matmul"
    want_runs = {f"{source}_prefill": int(prefill),
                 f"{source}_gemv": int(not prefill)}
    before = {n: cuda_build.launches[n] for n in want_runs}
    got, want = kern(x, ws[0], s, b), plain(x, ws[0], s, b)
    again = kern(x, ws[0], s, b)
    torch.cuda.synchronize()
    runs = {n: (cuda_build.launches[n] - before[n]) // 2 for n in want_runs}
    if runs != want_runs:
        raise AssertionError(f"{label}: cores that ran a call {runs}, want "
                             f"{want_runs}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: kernel output not finite")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = (ti8.prefill_plan(M, rows, N, sms) if prefill
            else ti8.gemv_plan(rows, N, sms))
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two calls of the "
                             f"{'prefill' if prefill else 'gemv'} kernel "
                             f"(splits {plan.splits}) differ")
    peak = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    extra = {"plan": dict(plan._asdict()), "bit_stable": True}
    del again
    if prefill and beside:
        with _first_mma_kernel():
            old = kern(x, ws[0], s, b)
        torch.cuda.synchronize()
        extra["old_max_abs_err"] = (old.float() - want.float()).abs().max(
            ).item()
        del old
    fault = (plain(x, ws[0], s.roll(1, dims=-1), b).float()
             - want.float()).abs().max().item()
    tol = WSMM_TOL * peak
    if not err <= tol:
        raise AssertionError(f"{label}: kernel vs plain max abs error {err} "
                             f"> {tol} ({WSMM_TOL} of the peak {peak})")
    if not fault > tol:
        raise AssertionError(f"{label}: planted fault (the neighbouring "
                             f"column's scale) passes the check: {fault} <= "
                             f"{tol}")
    del got, want
    wn = _rotation(ws)
    deq = [widen(w) * s for w in ws[:max(1, -(-n_copies // 2))]]
    dn = _rotation(deq)
    if b is None:
        library = lambda: torch.matmul(x, dn())
    else:
        library = lambda: torch.matmul(x, dn()) + b
    calls = {"kernel": lambda: kern(x, wn(), s, b),
             "plain": lambda: plain(x, wn(), s, b),
             "library": library}
    if beside:
        calls["eager"] = lambda: x @ (widen(wn()) * s)
    if prefill and beside:
        def old():
            with _first_mma_kernel():
                return kern(x, wn(), s, b)
        calls["old"] = old
    t = {k: _time_ms(torch, fn) for k, fn in calls.items()}
    per_call = []
    dev_t = {k: _device_ms(torch, calls[k],
                           counts=per_call if k == "kernel" else None)
             for k in calls if k != "plain" or not beside}
    extra["device_launches"] = per_call[0] if per_call else None
    ms, plain_ms, lib_ms = t["kernel"], t["plain"], t["library"]
    plan_line = (f"plan: {plan.m_tiles} x {plan.n_tiles} tiles of "
                 f"{plan.bm} x {ti8.PF_BN}, {plan.splits} K splits of "
                 f"{plan.k_tiles_per_split} tiles" if prefill else
                 f"the gemv's plan: {plan.tiles} column tiles of "
                 f"{16 * plan.cw} bytes x {plan.splits} K ranges of "
                 f"{plan.rows_per_split} rows")
    old_line = f"; {plan_line} (bit-stable over two calls)"
    if prefill and beside:
        extra.update({"old_ms": t["old"], "old_device_ms": dev_t["old"]})
        old_line = (f"; the first mma kernel on the same inputs: max_abs_err "
                    f"{extra['old_max_abs_err']:.3e}, {t['old']:.4f} ms, "
                    f"device {_ms(dev_t['old'])} ("
                    f"{_ratio(dev_t['old'], dev_t['kernel'])} the prefill "
                    f"kernel's){old_line}")
    del deq
    weight_bytes = rows * N
    bound = _bound(weight_bytes + 2 * N + 2 * M * K + 2 * M * N, 2 * M * K * N)
    if beside:
        beside_line = (f", eager dequantize + matmul {t['eager']:.4f} ms")
        dev_line = f", eager {_ms(dev_t['eager'])}"
        extra.update(eager_dequant_ms=t["eager"],
                     eager_dequant_device_ms=dev_t["eager"])
    else:
        beside_line = ""
        dev_line = f", plain {_ms(dev_t['plain'])}"
        extra["plain_device_ms"] = dev_t["plain"]
    print(f"[9] {label} {'int4' if int4 else 'int8'} x [{M}, {K}] @ w "
          f"[{rows}, {N}]{' + bias' if bias else ''}: max_abs_err {err:.3e} "
          f"(tol {WSMM_TOL} of the "
          f"peak {peak:.3f}); planted fault (neighbouring column's scale) "
          f"{fault:.3e} fails it; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library torch.matmul on dequantized bf16 "
          f"{lib_ms:.4f} ms{beside_line} "
          f"(CUDA-event medians of 20, wrapper included; {n_copies} weight "
          f"copies in turn); device time alone (profiler, mean of 20): "
          f"kernel {_ms(dev_t['kernel'])} ("
          f"{_rate(weight_bytes, dev_t['kernel'])} of weights), library "
          f"{_ms(dev_t['library'])}{dev_line}; bound "
          f"{bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}), {_ratio(bound['bound_ms'], dev_t['kernel'])}"
          f" of it; the core that ran: "
          f"{'prefill' if prefill else 'gemv'}; device launches a product "
          f"{extra['device_launches']}{old_line}")
    return {"max_abs_err": err, "peak": peak, "ms": ms, "plain_ms": plain_ms,
            **bound, "library_ms": lib_ms, "device_ms": dev_t["kernel"],
            "library_device_ms": dev_t["library"],
            "core": "prefill" if prefill else "gemv", **extra}


def phase_wsmm(torch, cuda_build, prefill_rows):
    """Kernels 9-11 at the understanding slice's shapes: int8 ``win``,
    ``wout`` and ``lm_head`` at decode (M=1) and at the prefill's rows,
    ``win`` at the CLIP-ViT prefill's rows, a ragged M=65 at ``lm_head``'s
    N, and both kernels at the probes' [8, 2048] x [2048, 8192]; int4 also
    at ``win``'s prefill and CLIP-ViT rows, the ragged ``lm_head`` M=65,
    and ``win``, ``wout`` and ``lm_head`` at decode (M=1); int8 at the
    serving engine's rows (SERVING_ROWS) at Phi's and Qwen2.5's products.
    Returns {counter: {case: result}}; the cases above M=4 also under their
    source's prefill counter, the serving cases under "serving"."""
    shapes = {"win": (2048, 14336), "wout": (10240, 2048),
              "lm_head": (2048, 58498)}
    cases = [(name, M, K, N) for name, (K, N) in shapes.items()
             for M in (1, prefill_rows)]
    cases += [("win", CLIP_PREFILL_ROWS, *shapes["win"]),
              ("lm_head", 65, *shapes["lm_head"]), ("probe", 8, 2048, 8192)]
    int4_cases = [("probe", 8, 2048, 8192),
                  ("win", prefill_rows, *shapes["win"]),
                  ("win", CLIP_PREFILL_ROWS, *shapes["win"]),
                  ("lm_head", 65, *shapes["lm_head"])]
    int4_cases += [(name, 1, K, N) for name, (K, N) in shapes.items()]
    out = {"int8_matmul": {}, "int4_matmul": {}, PREFILL_KERNEL: {},
           INT4_PREFILL_KERNEL: {}}
    for int4, source, prefill, seed0, todo in (
            (False, "int8_matmul", PREFILL_KERNEL, 91, cases),
            (True, "int4_matmul", INT4_PREFILL_KERNEL, 99, int4_cases)):
        for seed, (name, M, K, N) in enumerate(todo, start=seed0):
            label = f"{name} M={M}"
            out[source][label] = _wsmm_case(
                torch, cuda_build, label, M, K, N, int4, seed)
            if M > 4:
                out[prefill][label] = out[source][label]
    out["qwen"] = {}
    for seed, (name, M) in enumerate(
            ((name, M) for name in V2_INT8_SHAPES
             for M in (1, V2_PROMPT_ROWS)), start=121):
        K, N, bias = V2_INT8_SHAPES[name]
        label = f"qwen {name} M={M}"
        out["qwen"][label] = _wsmm_case(torch, cuda_build, label, M, K, N,
                                        False, seed, bias=bias, beside=False)
    # the serving engine's rows (phases 22 / 22b): decode at slots x window
    # (8, 24 with 2 drafts) and fused admission at slots + bucket (8 + 320)
    out["serving"] = {}
    todo = [(name, M, K, N, True) for name, (K, N) in shapes.items()
            for M in SERVING_ROWS]
    todo += [(f"qwen {name}", M, *V2_INT8_SHAPES[name]) for name in
             V2_INT8_SHAPES for M in SERVING_ROWS]
    for seed, (name, M, K, N, bias) in enumerate(todo, start=141):
        label = f"{name} M={M}"
        out["serving"][label] = _wsmm_case(torch, cuda_build, label, M, K, N,
                                           False, seed, bias=bias,
                                           beside=False)
    return out


def _mmu_image(size):
    from PIL import Image

    from showo_tpu_torch.utils.image import image_transform

    return image_transform(Image.open(MMU_IMAGE).convert("RGB"), size)


def _prefill(torch, phi, prompt):
    """One prefill forward of ``prompt`` ((ids or embeddings, bias)) by
    Phi ``phi`` into a fresh cache of an answer's capacity (prompt +
    MMU_NEW_TOKENS), as showo_mmu_generate runs it; returns the logits."""
    import torch.nn.functional as F

    from showo_tpu_torch.models.phi import KVCache

    first, bias = prompt
    S = first.shape[1]
    cap = S + MMU_NEW_TOKENS
    emb = phi.model.embed_tokens.weight
    cache = KVCache.zeros(phi.cfg, 1, cap, dtype=emb.dtype,
                          device=emb.device)
    bias = F.pad(bias, (0, cap - S), value=-1e9)
    key = "input_ids" if first.dtype == torch.int64 else "input_embeds"
    with torch.no_grad():
        return phi(attention_bias=bias, cache=cache, **{key: first})[0]


def _wall_ms(torch, fn, n=5):
    """Median host ms of ``fn`` over n calls, each ending in a sync."""
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def phase_mmu(torch, cuda_build, profile, pipe, label, answer, prompt,
              int8, smi, phase):
    """One understanding pipeline at full width: launches over its first
    greedy answer (int8: 49 x 101 of the int8 kernel, every other kernel
    none; bf16: none at all), tokens in the vocabulary, prompt / prefill
    times (medians of 3) and one warm answer's, decode ms per token against
    the weight-streaming bound, peak memory, and the device's idle share
    over one answer."""
    from torch import nn

    from showo_tpu_torch.models.phi import Int8Linear

    phi = pipe.model.showo
    lc = phi.cfg
    linear = Int8Linear if int8 else nn.Linear
    if not (lc.num_layers == NUM_LAYERS and lc.hidden_size == 2048
            and lc.vocab_size == 58498 and pipe.max_new_tokens ==
            MMU_NEW_TOKENS and pipe.top_k == 1
            and all(isinstance(m, linear) for layer in phi.model.layers
                    for m in (layer.win, layer.wout))
            and isinstance(phi.lm_head, linear)):
        raise AssertionError(f"{label}: not the full-width fused Phi with "
                             f"{linear.__name__} matmuls: {lc}")
    want = {name: 0 for name in COUNTERS}
    if int8:
        # every matmul of the prefill on the prefill kernel, of the decode
        # forwards on the gemv
        want["int8_matmul"] = MMU_MATMULS * (1 + MMU_NEW_TOKENS)
        want[PREFILL_KERNEL] = MMU_MATMULS
        want["int8_matmul_gemv"] = MMU_MATMULS * MMU_NEW_TOKENS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    t0 = time.perf_counter()
    toks = answer()
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    counts = {name: cuda_build.launches[name] for name in want}
    if counts != want:
        raise AssertionError(f"{label}: launches in one answer {counts}, "
                             f"want {want}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(0 <= t < lc.vocab_size for t in toks):
        raise AssertionError(f"{label}: tokens outside the vocabulary")
    prompt_ms = _wall_ms(torch, prompt, n=3)
    rows = prompt()[0].shape[1]
    prefill_ms = _wall_ms(torch, lambda: _prefill(torch, phi, prompt()), n=3)
    answer_ms = _wall_ms(torch, answer, n=1)
    decode_ms = (answer_ms - prompt_ms - prefill_ms) / MMU_NEW_TOKENS
    weight_bytes = sum(m.kernel_i8.numel() if int8 else 2 * m.weight.numel()
                       for m in [phi.lm_head] + [
                           w for layer in phi.model.layers
                           for w in (layer.win, layer.wout)])
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    prof = profile(answer, f"[{phase}] {label}: one answer,")
    kernel_prefill = _prefill_kernels(torch, phi, prompt()) if int8 else {}
    # the decode gemv's device launches and time per token, from the trace
    gemv = [row for name, row in prof["by_kernel"].items()
            if "gemv_kernel" in name]
    gemv_launches = sum(n for n, _ in gemv) / MMU_NEW_TOKENS
    gemv_ms = sum(ms for _, ms in gemv) / MMU_NEW_TOKENS
    print(f"[{phase}] {label}: {rows} prompt rows, greedy, {MMU_NEW_TOKENS} "
          f"new tokens ({len(toks)} before the first eot), launches per "
          f"answer {counts.get('int8_matmul', 0)} of int8_matmul = "
          f"{MMU_MATMULS} x {1 + MMU_NEW_TOKENS} ({counts[PREFILL_KERNEL]} on "
          f"the prefill kernel, {counts['int8_matmul_gemv']} on the gemv), 0 "
          f"of the others; prompt "
          f"{prompt_ms:.2f} ms, prefill {prefill_ms:.2f} ms, answer "
          f"{answer_ms:.2f} ms (first {first_wall * 1e3:.2f}; medians of "
          f"3 / 3, one warm answer), decode {decode_ms:.4f} ms per token = "
          f"{1e3 / decode_ms:.2f} tokens/s against a bound of "
          f"{bound_ms:.4f} ms ({weight_bytes / 1e9:.3f} GB of matmul weights"
          f" per token over 3.35 TB/s); device idle share over one answer "
          f"{prof['idle_share']:.4f} ({prof['launches']} kernel launches), "
          f"device busy {prof['busy_ms'] / MMU_NEW_TOKENS:.4f} ms per "
          f"token, of which the decode gemv {gemv_launches:.2f} device "
          f"launches and {gemv_ms:.4f} ms per token; peak memory "
          f"allocated {peak:.2f} GiB on {smi}")
    if int8:
        k = kernel_prefill
        print(f"[{phase}] {label}: the prefill forward alone ({rows} rows, "
              f"prompt made once): device {_ms(k['device_ms'])} with the "
              f"prefill kernel, {_ms(k['old_device_ms'])} with the first "
              f"mma kernel in its place (profiler, mean of 3); wall "
              f"{k['wall_ms']:.2f} vs {k['old_wall_ms']:.2f} ms (medians of "
              f"3)")
    return {"rows": rows, "prompt_ms": prompt_ms, "prefill_ms": prefill_ms,
            **{f"prefill_{key}": val for key, val in kernel_prefill.items()},
            "answer_ms": answer_ms, "decode_ms_per_token": decode_ms,
            "tokens_per_s": 1e3 / decode_ms, "bound_ms_per_token": bound_ms,
            "idle_share": prof["idle_share"], "peak_gib": peak,
            "busy_ms_per_token": prof["busy_ms"] / MMU_NEW_TOKENS,
            "gemv_device_launches_per_token": gemv_launches,
            "gemv_device_ms_per_token": gemv_ms,
            "launches": counts.get("int8_matmul", 0),
            "prefill_launches": counts[PREFILL_KERNEL]}


def _prefill_kernels(torch, phi, prompt):
    """Device and wall ms of one int8 prefill forward of ``prompt`` with
    the prefill kernel, then with the first mma kernel in its place."""
    def run():
        _prefill(torch, phi, prompt)

    out = {"device_ms": _device_ms(torch, run, iters=3),
           "wall_ms": _wall_ms(torch, run, n=3)}
    with _first_mma_kernel():
        out.update(old_device_ms=_device_ms(torch, run, iters=3),
                   old_wall_ms=_wall_ms(torch, run, n=3))
    return out


def _jax_order_int8(torch, phi_bf, phi_i8):
    """A copy of the bf16 Phi whose matmul weights are the JAX package's
    int8 serving weights, ``bf16(w_i8 * scale)`` (``phi.py::_wk``), taken
    from the int8 Phi and run through cuBLAS: int8 in JAX's order."""
    phi = copy.deepcopy(phi_bf)
    pairs = [(phi.lm_head, phi_i8.lm_head)] + [
        (getattr(a, n), getattr(b, n))
        for a, b in zip(phi.model.layers, phi_i8.model.layers)
        for n in ("win", "wout")]
    with torch.no_grad():
        for lin, q in pairs:
            lin.weight.copy_((q.kernel_i8.to(torch.bfloat16) * q.scale).t())
    return phi


def phase_mmu_turns(torch, pipes, image, mmu, device, pairs=1):
    """int8 against bf16 answers in turns (bf16, int8, int8, bf16, ...),
    since the host's clock drifts within a run more than the two differ:
    median answer times and the decode tokens/s they give (answer minus
    prompt and prefill), and the pairs int8 won."""
    walls = {0: [], 1: []}
    for order in ((0, 1), (1, 0)) * pairs:
        for int8 in order:
            gen = torch.Generator(device=device).manual_seed(0)
            t0 = time.perf_counter()
            pipes[int8].answer(image, MMU_QUESTION, gen)
            torch.cuda.synchronize()
            walls[int8].append((time.perf_counter() - t0) * 1e3)
    wins = sum(a < b for a, b in zip(walls[1], walls[0]))
    med = {k: statistics.median(v) for k, v in walls.items()}
    tps = {k: 1e3 * MMU_NEW_TOKENS / (med[k] - mmu[k]["prompt_ms"]
                                      - mmu[k]["prefill_ms"]) for k in med}
    print(f"[10] int8 against bf16 in turns ({2 * pairs} answers each): "
          f"answer {med[1]:.2f} vs {med[0]:.2f} ms (medians; int8 "
          f"{', '.join(f'{w:.1f}' for w in walls[1])}; bf16 "
          f"{', '.join(f'{w:.1f}' for w in walls[0])}), decode "
          f"{tps[1]:.2f} vs {tps[0]:.2f} tokens/s, int8 faster in {wins} "
          f"of {2 * pairs} pairs; prefill {mmu[1]['prefill_ms']:.2f} vs "
          f"{mmu[0]['prefill_ms']:.2f} ms, idle share "
          f"{mmu[1]['idle_share']:.4f} vs {mmu[0]['idle_share']:.4f}")


def phase_int8_parity(torch, pipe_bf, pipe_i8, phi32, image):
    """Prefill logits of one prompt with int8, bf16 and fp32 weights (the
    same seeded weights; fp32 with fp32 activations and full-fp32 matmuls,
    the unquantized reference of the JAX package's
    tests/test_int8_decode.py): int8 against fp32 is held to that test's
    limits (top-1 agreement, max abs difference over the reference's
    peak); int8 in JAX's order, int8 against bf16 and bf16 against fp32
    are read beside it."""
    ids, bias = pipe_bf.prompt(image, MMU_QUESTION)
    ids8, _ = pipe_i8.prompt(image, MMU_QUESTION)
    if not torch.equal(ids, ids8):
        raise AssertionError("bf16 and int8 pipelines built different "
                             "prompts")
    jax_order = _jax_order_int8(torch, pipe_bf.model.showo,
                                pipe_i8.model.showo)
    logits = {name: _prefill(torch, phi, (ids, bias)).float()[0]
              for name, phi in (("int8", pipe_i8.model.showo),
                                ("int8 in JAX's order", jax_order),
                                ("bf16", pipe_bf.model.showo),
                                ("fp32", phi32))}
    del jax_order

    def compare(a, b):
        got, ref = logits[a], logits[b]
        agree = (ref.argmax(-1) == got.argmax(-1)).float().mean().item()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        return agree, rel

    readings = {pair: compare(*pair) for pair in (
        ("int8", "fp32"), ("int8 in JAX's order", "fp32"), ("bf16", "fp32"),
        ("int8", "bf16"), ("int8", "int8 in JAX's order"))}
    ref = logits["fp32"]
    top2 = ref.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).median().item()
    print(f"[11] prefill logits ({pipe_bf.cfg.llm.num_layers} layers, "
          f"{ids.shape[1]} rows, vocab {ref.shape[-1]}; fp32 peak |logit| "
          f"{ref.abs().max().item():.3f}, median top-1 margin {margin:.4f}): "
          + "; ".join(f"{a} vs {b} top-1 agreement {g:.4f}, max abs "
                      f"difference / peak {r:.4e}"
                      for (a, b), (g, r) in readings.items())
          + f"; held: int8 vs fp32 >= {INT8_AGREE} and < {INT8_REL}")
    agree, rel = readings[("int8", "fp32")]
    if not (agree >= INT8_AGREE and rel < INT8_REL):
        raise AssertionError(f"int8 vs fp32 logits: agreement {agree}, "
                             f"relative difference {rel}")
    return readings


def phase_v2_kernels(torch, pipe, prompts):
    """Kernels 1 and 6 against their plain versions at the Show-o2 slice's
    shapes and metadata (the truncated [cond; null] rows of ``prompts``),
    Qwen2.5 and DiT heads; kernel 6 beside kernel 1; the planted fault.
    Returns {"packed": {label: result}, "stacked": {label: result}}."""
    import torch.nn.functional as F

    from showo_tpu_torch.ops import cuda_build
    from showo_tpu_torch.ops import flash_attention as tfa
    from showo_tpu_torch.pipelines.t2i_v2 import attention_inputs

    text, mp = pipe.build_inputs(prompts)
    meta = attention_inputs(pipe.attn_route, text, mp)[1]
    B, L = text.shape
    m = (meta.seg, meta.pad, meta.last_pad, meta.prefix)
    vis = tfa.visible_mask(*m, meta.pos_q)
    n_vis = int(vis.sum())
    # seg, pad, pos_q, seg_q [B, L] and last_pad, prefix [B], int32
    meta_bytes = 4 * (4 * B * L + 2 * B)
    print(f"[3c] the slice's rows: B={B} S={L} (spans {mp[:, 0].tolist()}); "
          f"{n_vis} visible (row, key) pairs of {B * L * L} "
          f"({n_vis / (B * L * L):.4f})")
    g = torch.Generator(device="cuda").manual_seed(31)
    out = {"packed": {}, "stacked": {}}
    for label, H, Hkv, D in V2_SHAPES:
        if not tfa.gqa_stack_fits(L, L, H // Hkv):
            raise AssertionError(f"{label}: the JAX package would not stack")
        q, k, v = (torch.randn(B, L, n * D, generator=g, device="cuda")
                   .bfloat16() for n in (H, Hkv, Hkv))
        kw = dict(num_heads=H, num_kv_heads=Hkv)
        # the model path's call: its tile map made once with the metadata
        rows = dict(q_positions=meta.pos_q, seg_q=meta.seg_q,
                    tiles=meta.tiles)
        heads = [t.unflatten(-1, (-1, D)).transpose(1, 2) for t in (q, k, v)]
        shape = f"{label}: B={B} S={L} H={H} Hkv={Hkv} D={D}"
        bound = _bound(2 * (2 * B * L * H + 2 * B * L * Hkv) * D + meta_bytes,
                       4 * D * H * n_vis)

        def sdpa():
            return F.scaled_dot_product_attention(
                *heads, attn_mask=vis[:, None], enable_gqa=Hkv != H)

        plains = {
            "packed": lambda v_: tfa.omni_attention_packed_plain(
                q, k, v_, *m, meta.pos_q, sm_scale=D ** -0.5, **kw),
            "stacked": lambda v_: tfa.omni_attention_gqa_stacked_plain(
                q, k, v_, *m, meta.pos_q, sm_scale=D ** -0.5, **kw)}
        kernels = {
            "packed": lambda: tfa.omni_attention_packed(q, k, v, *m, **rows,
                                                        **kw),
            "stacked": lambda: tfa.omni_attention_packed(
                q, k, v, *m, gqa_stack=True, **rows, **kw)}
        before = {n: cuda_build.launches[n]
                  for n in ("omni_attention_packed", PACKED_WGMMA,
                            GQA_SOURCE, GQA_WGMMA, GQA_TILES)}
        for which, num in (("packed", 1), ("stacked", 6)):
            out[which][label] = _compare(
                torch, f"kernel {num} {shape}", kernels[which],
                lambda: plains[which](v), bound, sdpa, phase="3c")
        made = {n: cuda_build.launches[n] - c for n, c in before.items()}
        if not (made["omni_attention_packed"] == made[PACKED_WGMMA] > 0
                and made[GQA_SOURCE] == made[GQA_WGMMA] > 0
                and made[GQA_TILES] == 0):
            raise AssertionError(f"{shape}: launches {made}: kernels 1 and 6 "
                                 f"not all on the wgmma core, or kernel 6 "
                                 f"made a map of its own")
        # kernel 6 beside kernel 1 on the same memory and map: each one's
        # device time a launch, and the library's
        dev_ms = {"packed": _device_ms(torch, kernels["packed"]),
                  "stacked": _device_ms(torch, kernels["stacked"]),
                  "library": _device_ms(torch, sdpa)}
        for which in ("packed", "stacked"):
            out[which][label].update({
                "device_ms": dev_ms[which],
                "library_device_ms": dev_ms["library"],
                "width": tfa.stack_width(H // Hkv)})
        beside = (kernels["packed"]().float()
                  - kernels["stacked"]().float()).abs().max().item()
        out["stacked"][label]["kernel1_diff"] = beside
        if not beside <= CARD_TOL:
            raise AssertionError(f"{shape}: kernel 6 and kernel 1 differ by "
                                 f"{beside}")
        wrong = v.view(B, L, Hkv, D).roll(1, dims=2).reshape(v.shape)
        faults = {}
        for which, plain in plains.items():
            faults[which] = (plain(wrong).float()
                             - plain(v).float()).abs().max().item()
            if not faults[which] > CARD_TOL:
                raise AssertionError(f"{shape}: the planted fault passes the "
                                     f"{which} check: {faults[which]}")
        print(f"[3c] {shape}: kernel 6 ({tfa.stack_width(H // Hkv)} q "
              f"heads a block, {made[GQA_WGMMA]} launches, all on the wgmma "
              f"core, on the slice's tile map) beside kernel 1 on the same "
              f"inputs and map, max |difference| {beside:.3e} (0 expected: "
              f"each head's arithmetic is kernel 1's; tol {CARD_TOL:.0e}); "
              f"device time a launch (profiler, mean of 20): kernel 6 "
              f"{_ms(dev_ms['stacked'])}, kernel 1 {_ms(dev_ms['packed'])}, "
              f"library {_ms(dev_ms['library'])}; planted fault (V of the "
              f"neighbouring kv head) in the plain versions: "
              f"{faults['packed']:.3e} (kernel 1), {faults['stacked']:.3e} "
              f"(kernel 6), each failing the check (tol {CARD_TOL:.0e})")
        out["packed"][label]["old_ms"] = out["stacked"][label]["ms"]
        del q, k, v, heads, wrong
    out["tiles"] = _v2_tile_map_check(torch, tfa, meta)
    for _, H_, Hkv_, D_ in V2_SHAPES:
        _v2_ragged(torch, tfa, H_, Hkv_, D_)
    return out


def _v2_tile_map_check(torch, tfa, meta):
    """Kernel 1's tile map at D=128 of the slice's metadata against its
    plain version; returns its result."""
    m = (meta.seg, meta.pad, meta.last_pad, meta.prefix)
    B, L = meta.seg.shape
    nt = -(-L // 64)
    return _map_check(
        torch, f"kernel 1's tile map at D=128 [{B}, {nt}, {nt + 1}]",
        lambda: tfa.rows_tile_map(*m, meta.pos_q, meta.seg_q),
        lambda: tfa.rows_tile_map_plain(*m, meta.pos_q),
        4 * (4 * B * L + 2 * B) + B * nt * (nt + 1), B * (nt * 64) ** 2,
        "3c", flag=True)[1]


def _v2_ragged(torch, tfa, H, Hkv, D):
    """Kernel 1 on the wgmma core at head dim ``D`` (``H`` q / ``Hkv`` kv
    heads) on a ragged S=200 whose rows 6..9 see no key: against its plain
    version, those rows against the mean of v over the S keys, the same
    bits over two launches."""
    dev = torch.device("cuda")
    m = _ragged_meta(torch, dev)
    B, S = m[0].shape
    g = torch.Generator(device=dev).manual_seed(32 + D)
    q, k, v = (torch.randn(B, S, n * D, generator=g, device=dev).bfloat16()
               for n in (H, Hkv, Hkv))
    kw = dict(num_heads=H, num_kv_heads=Hkv)
    runs = [tfa.omni_attention_packed(q, k, v, *m, **kw) for _ in range(2)]
    pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S)
    want = tfa.omni_attention_packed_plain(q, k, v, *m, pos,
                                           sm_scale=D ** -0.5, **kw)
    torch.cuda.synchronize()
    err = (runs[0].float() - want.float()).abs().max().item()
    mean_v = v.float().view(B, S, Hkv, D).mean(dim=1).repeat_interleave(
        H // Hkv, dim=1).reshape(B, 1, H * D)
    empty_err = (runs[0][:, 6:10].float() - mean_v).abs().max().item()
    same = torch.equal(runs[0], runs[1])
    print(f"[3c] kernel 1 at D={D}, ragged B={B} S={S} H={H} Hkv={Hkv}, "
          f"rows 6..9 see no key: max_abs_err {err:.3e} against the plain "
          f"version, those rows {empty_err:.3e} from the mean of v (tol "
          f"{CARD_TOL:.0e}); two launches bit-identical: {same}")
    if not (err <= CARD_TOL and empty_err <= CARD_TOL and same):
        raise AssertionError(f"kernel 1 at D={D}, ragged: error {err}, rows "
                             f"without keys {empty_err}, bit-identical "
                             f"{same}")


def _v2_full_width(pipe) -> bool:
    """Whether ``pipe`` holds Show-o2 1.5B at 432x432 at full width (Qwen2.5
    28 layers, 12 / 2 heads of 128; the DiT 10 layers, 32 / 8 of 64;
    SigLIP 26 layers; 27x27 patches and the time token an image) and the
    released Wan2.1 VAE."""
    cfg = pipe.cfg
    lc, dc, sc = cfg.llm, cfg.dit, cfg.siglip
    return (lc.num_layers == 28 and lc.hidden_size == 1536
            and (lc.num_heads, lc.num_kv_heads, lc.head_dim) == (12, 2, 128)
            and lc.vocab_size == 151940 and dc.num_layers == 10
            and dc.hidden_size == 2048
            and (dc.num_heads, dc.num_kv_heads, dc.head_dim) == (32, 8, 64)
            and sc.num_layers == 26 and sc.hidden_size == 1152
            and cfg.num_image_tokens == 730 and pipe.vae.cfg.dim == 96
            and pipe.vae.cfg.temperal_downsample == (False, True, True))


def phase_v2_slice(torch, np, cuda_build, pipe, prompts, smi):
    """The Show-o2 432x432 pipeline: launch counts over one generate call,
    output checks, warm wall time and peak memory.  Returns (kernel 1
    launches of one generate, the slice's readings).  The time by
    operator of one generate is ``profile_t2i.py --slice v2``'s (its
    ~200,000 launches take the profiler minutes)."""
    cfg = pipe.cfg
    if not (pipe.attn_route == "packed" and _v2_full_width(pipe)
            and pipe.num_steps == 50 and pipe.guidance_scale == 7.5):
        raise AssertionError(f"not the full-width Show-o2 432x432 path: "
                             f"{pipe.attn_route}, {cfg}, {pipe.vae.cfg}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    pipe.generate(prompts, gen)                       # warm-up
    want = {name: 0 for name in COUNTERS}
    want["omni_attention_packed"] = V2_LAYERS * V2_EVALS
    want[PACKED_WGMMA] = V2_LAYERS * V2_EVALS   # every one on the core
    want[PACKED_TILES] = 1      # made once with the generate's metadata
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    images = pipe.generate(prompts, gen)
    counts = {name: cuda_build.launches[name] for name in want}
    if counts != want:
        raise AssertionError(f"v2: kernel launches in one generate call "
                             f"{counts}, want {want}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if images.shape != (V2_BATCH, 432, 432, 3) or not np.isfinite(
            images).all():
        raise AssertionError(f"v2: images {images.shape} or non-finite")
    if images.min() < -1.0 or images.max() > 1.0:
        raise AssertionError("v2: images outside [-1, 1]")
    walls = []
    for _ in range(2):
        before = dict(cuda_build.launches)
        t0 = time.perf_counter()
        pipe.generate(prompts, gen)
        walls.append(time.perf_counter() - t0)
        if {n: cuda_build.launches[n] - before.get(n, 0)
                for n in want} != want:
            raise AssertionError("v2: launch counts changed")
    wall = statistics.median(walls)
    text, _ = pipe.build_inputs(prompts)
    print(f"[12] slice Show-o2 1.5B t2i 432x432 route packed, 50-point "
          f"Euler ({V2_EVALS} velocity evaluations), CFG 7.5, batch "
          f"{V2_BATCH} ({tuple(text.shape)} rows x tokens), bf16, VAE fp32, "
          f"random weights: launches per generate "
          f"{counts['omni_attention_packed']} = {V2_LAYERS} x {V2_EVALS} of "
          f"omni_attention_packed ({V2_QWEN_LAYERS} x {V2_EVALS} at "
          f"D=128, {V2_LAYERS - V2_QWEN_LAYERS} x {V2_EVALS} at D=64; "
          f"{counts[PACKED_WGMMA]} on the wgmma core, all reading "
          f"{counts[PACKED_TILES]} tile map), 0 of the others "
          f"({GQA_SOURCE} among them); images {images.shape} finite in [-1, 1]; warm wall "
          f"{wall:.4f} s/batch (median of 2: "
          f"{', '.join(f'{w:.4f}' for w in walls)}), "
          f"{V2_BATCH * 60.0 / wall:.2f} images/min; peak memory allocated "
          f"{peak:.2f} GiB on {smi}")
    return counts, {"wall_s": wall, "images_per_min": V2_BATCH * 60.0 / wall,
                    "peak_gib": peak}


def phase_v2_parity(torch, pipe, prompts):
    """One full-width velocity evaluation on the packed route against dense
    attention under the additive omni mask: the same weights, latents and
    t.  The reference's zero init of the DiT's adaLN projections and of the
    FinalLayer makes the velocity 0 whatever the towers compute, so they
    are drawn N(0, 0.02) first; phases 15-17 run on these weights."""
    from showo_tpu_torch.pipelines.t2i_v2 import attention_inputs
    from showo_tpu_torch.show_o2.masks import omni_attn_mask
    from showo_tpu_torch.show_o2.showo2 import showo2_t2i_velocity

    model, cfg = pipe.model, pipe.cfg
    g = _draw_adaln(torch, model, 13)
    text, mp = pipe.build_inputs(prompts)
    B, L = text.shape
    z = torch.randn(B // 2, cfg.image_latent_dim, cfg.image_latent_height,
                    cfg.image_latent_width, generator=g, device="cuda")
    x = torch.cat([z, z])
    t = torch.full((B,), 0.5, device="cuda")
    inputs = {"packed": (None, attention_inputs(pipe.attn_route, text,
                                                mp)[1]),
              "dense": (omni_attn_mask(mp, L), None)}
    v = {}
    with torch.no_grad():
        for route, (bias, meta) in inputs.items():
            for cfg_scale in (0.0, pipe.guidance_scale):
                v[route, cfg_scale] = showo2_t2i_velocity(
                    model, text, x, t, bias, mp, guidance_scale=cfg_scale,
                    attn_meta=meta).float()
    rel = {s: ((v["packed", s] - v["dense", s]).abs().max()
               / v["dense", s].abs().max()).item()
           for s in (0.0, pipe.guidance_scale)}
    peak = v["dense", 0.0].abs().max().item()
    print(f"[13] velocity parity packed vs dense (28 + 10 layers, "
          f"{tuple(text.shape)}, bf16, t 0.5): max |dv| / peak "
          f"{rel[0.0]:.4e} unguided (peak |v| {peak:.4f}; tol "
          f"{V2_STEP_TOL}), {rel[pipe.guidance_scale]:.4e} with CFG "
          f"{pipe.guidance_scale}")
    if not rel[0.0] <= V2_STEP_TOL:
        raise AssertionError(f"v2 velocity packed vs dense differs by "
                             f"{rel[0.0]} of the peak > {V2_STEP_TOL}")
    return rel


def _draw_adaln(torch, model, seed: int):
    """The DiT's adaLN projections and the FinalLayer drawn N(0, 0.02) in
    place (their reference zero init makes the velocity 0 whatever the
    towers compute); returns the generator, to draw on from."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "adaLN_modulation" in name or "diffusion_head_b.linear" in name:
                p.copy_(torch.randn(p.shape, generator=g, device="cuda")
                        * 0.02)
    return g


def phase_v1_modes(torch, np, cuda_build, base, prompts, smi):
    """Inpainting (the in-tree pair, every route) and extrapolation (two
    directions) at 512x512 on the full-width slice model of ``base`` (the
    CLI's ``build_pipeline``, ``auto``); launch counts of
    each call, codes, images, warm seconds.  Returns {route: launches of
    one inpaint}, the extrapolation's launches."""
    from PIL import Image

    from showo_tpu_torch.pipelines.t2i import T2IPipeline
    from showo_tpu_torch.utils.assets import inpainting_pair
    from showo_tpu_torch.utils.image import (bicubic_resize_mask,
                                             image_transform)

    cfg, res = base.cfg, base.resolution
    if res != 512 or cfg.num_vq_tokens != 1024:
        raise AssertionError(f"not the 512x512 slice: {res}, {cfg}")
    src, msk = inpainting_pair()
    image = image_transform(Image.open(src).convert("RGB"), res)
    mask = image_transform(Image.open(msk).convert("L"), res,
                           normalize=False)[:, :, 0]
    masked = bicubic_resize_mask(mask, res // 16).reshape(-1).astype(bool)
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for route in KERNELS:
        pipe = T2IPipeline(
            model=base.model, vq=base.vq, uni_prompting=base.uni_prompting,
            guidance_scale=base.guidance_scale, timesteps=base.timesteps,
            mask_schedule=base.mask_schedule,
            max_seq_length=base.max_seq_length, resolution=res,
            attn_impl=route)
        pipe.inpaint(prompts[0], image, mask, gen, batch_size=BATCH)
        want = _route_want(route)
        cuda_build.launches.clear()
        images = pipe.inpaint(prompts[0], image, mask, gen,
                              batch_size=BATCH)
        counts = {name: cuda_build.launches[name] for name in want}
        if counts != want:
            raise AssertionError(f"inpaint {route}: launches {counts}, want "
                                 f"{want}")
        _check_images(np, images, (BATCH, res, res, 3), f"inpaint {route}")
        t0 = time.perf_counter()
        codes = pipe.inpaint_codes(prompts[0], image, mask, gen,
                                   batch_size=BATCH).cpu().numpy()
        wall = time.perf_counter() - t0
        own = pipe.encode(image)[0] - cfg.codebook_offset
        if not (codes.min() >= 0 and codes.max() < cfg.codebook_size
                and (codes[:, ~masked] == own[~masked]).all()):
            raise AssertionError(f"inpaint {route}: codes out of the "
                                 f"codebook or the unmasked tokens changed")
        print(f"[14] inpaint 512x512 route {route}, the in-tree pair "
              f"({int(masked.sum())} of {masked.size} tokens under the "
              f"mask), {TIMESTEPS} steps, CFG {pipe.guidance_scale}, batch "
              f"{BATCH}: launches {counts[KERNELS[route][0]]} = {NUM_LAYERS} "
              f"x {TIMESTEPS} of {KERNELS[route][0]} (all on the wgmma "
              f"core, {counts[ROUTE_TILES[route]]} tile maps), 0 of the "
              f"others; the unmasked tokens kept; images {images.shape} "
              f"finite in [-1, 1]; warm {wall:.4f} s (codes) on {smi}")
        out[route] = {n: c for n, c in counts.items() if c}
    pipe = T2IPipeline(
        model=base.model, vq=base.vq, uni_prompting=base.uni_prompting,
        guidance_scale=base.guidance_scale, timesteps=base.timesteps,
        max_seq_length=base.max_seq_length, resolution=res,
        attn_impl="packed")
    dirs, texts = list(EXTRA_DIRECTIONS), prompts[:len(EXTRA_DIRECTIONS)]
    pipe.extrapolate(texts, dirs, image, gen, batch_size=BATCH)
    want = {n: c * len(dirs) if c else 0
            for n, c in _route_want("packed").items()}
    cuda_build.launches.clear()
    t0 = time.perf_counter()
    images = pipe.extrapolate(texts, dirs, image, gen, batch_size=BATCH)
    wall = time.perf_counter() - t0
    counts = {name: cuda_build.launches[name] for name in want}
    if counts != want:
        raise AssertionError(f"extrapolate: launches {counts}, want {want}")
    W = res // 16
    rows = W + len(dirs) * (W - W // 2)
    _check_images(np, images, (BATCH, rows * 16, res, 3), "extrapolate")
    grid = pipe.extrapolate_codes(texts, dirs, image, gen, batch_size=BATCH)
    if not (grid.shape == (BATCH, rows, W) and grid.min() >= 0
            and grid.max() < cfg.codebook_size):
        raise AssertionError(f"extrapolate: grid {grid.shape} or codes out "
                             f"of the codebook")
    print(f"[14] extrapolate 512x512 {' then '.join(dirs)} (offset 0), "
          f"packed, batch {BATCH}: launches "
          f"{counts['omni_attention_packed']} = {len(dirs)} x {NUM_LAYERS} x "
          f"{TIMESTEPS} (all on the wgmma core), 0 of the others; code grid "
          f"{grid.shape[1:]}, images {images.shape} finite in [-1, 1]; warm "
          f"{wall:.4f} s")
    return out, {n: c for n, c in counts.items() if c}


def _route_want(route):
    """The launches of one cached MaskGIT generate on ``route``: its
    kernel's in every layer of every step (on ``packed`` all on the wgmma
    core), one tile map a forward, and on ``fused`` a LayerNorm + RoPE pass
    before each core; none of the other kernels."""
    want = {name: 0 for name in COUNTERS}
    want[KERNELS[route][0]] = NUM_LAYERS * TIMESTEPS
    if route == "packed":
        want[PACKED_WGMMA] = NUM_LAYERS * TIMESTEPS
    want[ROUTE_TILES[route]] = TIMESTEPS
    if route == "fused":
        want[FUSED_NORM] = NUM_LAYERS * TIMESTEPS
    return want


def _check_images(np, images, shape, label):
    if images.shape != shape or not np.isfinite(images).all():
        raise AssertionError(f"{label}: images {images.shape} (want "
                             f"{shape}) or not finite")
    if images.min() < -1.0 or images.max() > 1.0:
        raise AssertionError(f"{label}: images outside [-1, 1]")


def phase_v2_cached_kernels(torch, pipe, prompts):
    """Kernels 1 and 5 at the Show-o2 slice's cached shapes: B=8 fresh
    rows of the image span (Q=730) at the generate's per-row offsets
    against the K=768 cached keys, Qwen2.5 and DiT heads, through the
    model's call (``qwen2.gqa_attention`` on [B, S, H, D] views, the
    tile map made once with the fresh rows' metadata); the map byte for
    byte; a fault planted in the plain version (one row's offset + 1)
    must fail (V of the keys past each span, which no fresh row sees, set
    large: ``_tail_values``).  Returns {"packed": {label: result},
    "streaming": ...}."""
    import torch.nn.functional as F

    from showo_tpu_torch.ops import flash_attention as tfa
    from showo_tpu_torch.ops import streaming_attention as tsa
    from showo_tpu_torch.pipelines.t2i_v2 import attention_inputs
    from showo_tpu_torch.show_o2 import qwen2 as tqwen2

    text, mp = pipe.build_inputs(prompts)
    B, L = text.shape
    rows = tqwen2.cache_rows(mp[:, 0, 0], pipe.cfg.num_image_tokens)
    n = rows[1].shape[1]
    base = attention_inputs(pipe.attn_route, text, mp, rows[1])[1]
    m = (base.seg, base.pad, base.last_pad, base.prefix)
    metas = {route: tqwen2.packed_meta((route, *m), rows[1])
             for route in ("packed", "streaming")}
    vis = tfa.visible_mask(*m, base.pos_q)
    n_vis = int(vis.sum())
    print(f"[15] the cached rows: B={B} Q={n} K={L}, offsets "
          f"{mp[:, 0, 0].tolist()}; {n_vis} visible (row, key) pairs of "
          f"{B * n * L} ({n_vis / (B * n * L):.4f})")
    makers = {"packed": tfa.rows_tile_map, "streaming": tsa.streaming_tile_map}
    maps = {}
    for route, meta in metas.items():
        tiles, maps[route] = _map_check(
            torch, f"{route}'s tile map of the fresh rows "
            f"{tuple(meta.tiles.shape)}",
            lambda route=route: makers[route](*m, base.pos_q, base.seg_q),
            lambda: tfa.rows_tile_map_plain(*m, base.pos_q),
            4 * (4 * B * L + 2 * B) + meta.tiles.numel(),
            B * (-(-n // 64) * 64) * (-(-L // 64) * 64), 15, flag=True)
        if not torch.equal(meta.tiles, tiles):
            raise AssertionError(f"{route}: the map the model reads differs")
    g = torch.Generator(device="cuda").manual_seed(41)
    out = {"packed": {}, "streaming": {}, "tiles": maps}
    for label, H, Hkv, D in V2_SHAPES:
        q = torch.randn(B, n, H, D, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(B, L, Hkv, D, generator=g, device="cuda")
                .bfloat16() for _ in range(2))
        _tail_values(v, mp)
        heads = [t.transpose(1, 2) for t in (q, k, v)]
        shape = f"{label}: B={B} Q={n} K={L} H={H} Hkv={Hkv} D={D}"
        bound = _bound(2 * (2 * B * n * H + 2 * B * L * Hkv) * D
                       + 4 * (4 * B * L + 2 * B), 4 * D * H * n_vis)

        def sdpa():
            return F.scaled_dot_product_attention(
                *heads, attn_mask=vis[:, None], enable_gqa=Hkv != H)

        def plain(route, pos):
            if route == "streaming":
                return tsa.omni_attention_streaming_plain(
                    *heads, *m, pos, sm_scale=D ** -0.5).transpose(
                        1, 2).reshape(B, n, H * D)
            return tfa.omni_attention_packed_plain(
                q.reshape(B, n, -1), k.reshape(B, L, -1),
                v.reshape(B, L, -1), *m, pos, num_heads=H,
                num_kv_heads=Hkv, sm_scale=D ** -0.5)

        for route, num in (("packed", 1), ("streaming", 5)):
            meta = metas[route]

            def kern(meta=meta):
                return tqwen2.gqa_attention(q, k, v, None, meta)

            res = _compare(torch, f"kernel {num} {shape}", kern,
                           lambda route=route: plain(route, base.pos_q),
                           bound, sdpa, phase=15)
            got = kern()
            same = torch.equal(got, kern())
            shifted = base.pos_q.clone()
            shifted[2] += 1
            fault = (got.float() - plain(route, shifted).float()).abs().max(
                ).item()
            if not (same and fault > CARD_TOL):
                raise AssertionError(f"{shape} kernel {num}: bit-identical "
                                     f"{same}, planted offset fault {fault}")
            dev_ms = _device_ms(torch, kern)
            lib_dev = _device_ms(torch, sdpa)
            res.update({"device_ms": dev_ms, "library_device_ms": lib_dev,
                        "planted_fault": fault})
            print(f"[15] kernel {num} {shape}: two launches bit-identical; "
                  f"planted fault (row 2's offset + 1) in the plain version "
                  f"{fault:.3e}, failing the check (tol {CARD_TOL:.0e}); "
                  f"device time a launch (profiler, mean of 20) "
                  f"{_ms(dev_ms)}, library {_ms(lib_dev)}")
            out[route][label] = res
        del q, k, v, heads
    return out


def _tail_values(v, mp, value: float = 64.0) -> None:
    """V of the keys past each row's image span (its eoi / pad rows, which
    no fresh row sees) set to ``value``, in place: a q row at a wrong
    position past the span then sees one and moves by ~value / K, so the
    planted offset fault shows above the check's tolerance."""
    for b, (off, length) in enumerate(mp[:, 0].tolist()):
        v[b, off + length:] = value


def _v2_variant(pipe, **kw):
    """A Show-o2 pipeline on ``pipe``'s model and VAE with other options."""
    from showo_tpu_torch.pipelines.t2i_v2 import T2IV2Pipeline

    opts = dict(guidance_scale=pipe.guidance_scale, num_steps=pipe.num_steps,
                time_shifting_factor=pipe.time_shifting_factor,
                max_text_len=pipe.max_text_len, attn_impl="packed")
    opts.update(kw)
    return T2IV2Pipeline(model=pipe.model, vae=pipe.vae,
                         tokenizer=pipe.tokenizer, token_ids=pipe.token_ids,
                         **opts)


def _v2_run(torch, np, cuda_build, pipe, prompts, z, want, label):
    """One counted generate of ``pipe`` from noise z: launch counts against
    ``want``, images checked; returns (latents, wall s, counts)."""
    cuda_build.launches.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = pipe.generate_latents(prompts, noise=z)
    images = pipe.decode(lat)
    wall = time.perf_counter() - t0
    counts = {name: cuda_build.launches[name] for name in want}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, want {want}")
    _check_images(np, images, (V2_BATCH, 432, 432, 3), label)
    return lat, wall, counts


def _v2_want(**counts):
    want = {name: 0 for name in COUNTERS}
    want.update(counts)
    return want


def _latent_diff(a, b, label, phase):
    rel = ((a - b).abs().max() / b.abs().max()).item()
    if not rel <= V2_LATENT_TOL:
        raise AssertionError(f"{label}: latents differ by {rel} of the peak "
                             f"> {V2_LATENT_TOL}")
    return rel


def phase_v2_cached(torch, np, cuda_build, pipe, prompts, smi):
    """The Show-o2 slice with ``prefix_cache=True`` (Euler 50, the weights
    of phase 13): launch counts, latents against the uncached pipeline on
    the same noise, warm seconds in turns, peak memory.  Returns (counts,
    readings, the noise, the uncached latents, the uncached wall)."""
    cached = _v2_variant(pipe, prefix_cache=True)
    g = torch.Generator(device="cuda").manual_seed(17)
    z = torch.randn(V2_BATCH, 16, 54, 54, generator=g, device="cuda")
    want = _v2_want(omni_attention_packed=V2_CACHED_LAUNCHES,
                    **{PACKED_WGMMA: V2_CACHED_LAUNCHES,
                       PACKED_TILES: V2_CACHED_MAPS})
    plain_want = _v2_want(omni_attention_packed=V2_LAYERS * V2_EVALS,
                          **{PACKED_WGMMA: V2_LAYERS * V2_EVALS,
                             PACKED_TILES: 1})
    cached.generate_latents(prompts, noise=z)             # warm-up
    walls = {"cached": [], "uncached": []}
    lat = {}
    for turn in range(2):
        for which, p, w in (("cached", cached, want),
                            ("uncached", pipe, plain_want)):
            if turn == 0 and which == "cached":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            lat[which], wall, counts = _v2_run(
                torch, np, cuda_build, p, prompts, z, w, f"v2 {which}")
            walls[which].append(wall)
            if turn == 0 and which == "cached":
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                cached_counts = counts
    moved = (lat["uncached"] - z).abs().max().item()
    if not moved > 1e-2:
        raise AssertionError(f"v2: the steps did not move z ({moved})")
    rel = _latent_diff(lat["cached"], lat["uncached"],
                       "v2 cached vs uncached", 16)
    med = {k: statistics.median(v) for k, v in walls.items()}
    counts = cached_counts
    print(f"[16] slice Show-o2 t2i 432x432 prefix_cache=True, packed, Euler "
          f"50, CFG 7.5, batch {V2_BATCH}: launches per generate "
          f"{counts['omni_attention_packed']} = {V2_LAYERS} x (1 prefill + "
          f"{V2_EVALS} cached evaluations) of omni_attention_packed "
          f"({counts[PACKED_WGMMA]} on the wgmma core), "
          f"{counts[PACKED_TILES]} tile maps a generate (the prefill's rows "
          f"and the fresh rows'), 0 of the others; latents (moved by up to "
          f"{moved:.3f} from z) against the uncached pipeline on the same "
          f"noise: max |d| / peak {rel:.4e} (tol {V2_LATENT_TOL}); warm s a "
          f"batch in turns cached "
          f"{', '.join(f'{w:.4f}' for w in walls['cached'])} / uncached "
          f"{', '.join(f'{w:.4f}' for w in walls['uncached'])}: "
          f"{V2_BATCH * 60 / med['cached']:.2f} / "
          f"{V2_BATCH * 60 / med['uncached']:.2f} images/min; peak memory "
          f"allocated {peak:.2f} GiB (cached) on {smi}")
    return counts, {"wall_s": med["cached"], "uncached_wall_s":
                    med["uncached"], "latent_rel_diff": rel, "peak_gib": peak,
                    "images_per_min": V2_BATCH * 60 / med["cached"]}, \
        z, lat["uncached"], med["uncached"]


@contextlib.contextmanager
def _shallow(model, qwen: int, dit: int, siglip: int):
    """``model`` with only its first ``qwen`` / ``dit`` / ``siglip``
    layers (the same widths and weights), restored after."""
    nn = type(model.diffusion_head_a)
    parts = [(model.showo.model, "layers", qwen),
             (model, "diffusion_head_a", dit),
             (model.und_trans, "layers", siglip)]
    full = [getattr(owner, name) for owner, name, _ in parts]
    try:
        for (owner, name, n), layers in zip(parts, full):
            setattr(owner, name, nn(list(layers)[:n]))
        yield
    finally:
        for (owner, name, _), layers in zip(parts, full):
            setattr(owner, name, layers)


def phase_v2_samplers(torch, np, cuda_build, pipe, prompts, smi, z, ref,
                      euler_s):
    """DPM-Solver++ at 20 points and Heun at 50 at full depth, dopri5 (its
    velocity evaluations printed) at the depth of ``V2_DOPRI5_DEPTH``,
    then the ``streaming`` route without and with the prefix cache, its
    latents against ``packed``'s (``ref``, from noise z); seconds and
    images/min beside Euler (``euler_s``).  Returns (streaming counts
    uncached, cached, readings)."""
    out = {}
    for method, points in V2_SAMPLERS:
        p = _v2_variant(pipe, sampling_method=method, num_steps=points)
        evals = {"dpm-solver": points - 1, "heun": 2 * (points - 1)}
        depth = (V2_DOPRI5_DEPTH if method == "dopri5"
                 else (V2_QWEN_LAYERS, V2_LAYERS - V2_QWEN_LAYERS, 26))
        rows = prompts if method != "dopri5" else prompts[:1]
        cuda_build.launches.clear()
        with _shallow(pipe.model, *depth):
            t0 = time.perf_counter()
            lat = p.generate_latents(rows, noise=z[:len(rows)])
            images = p.decode(lat)
            wall = time.perf_counter() - t0
        nfe = p.sampler_stats.get("nfe", evals.get(method))
        launches = cuda_build.launches["omni_attention_packed"]
        if launches != (depth[0] + depth[1]) * nfe:
            raise AssertionError(f"{method}: {launches} kernel 1 launches "
                                 f"for {nfe} evaluations")
        _check_images(np, images, (len(rows), 432, 432, 3), method)
        stats = "".join(f", {k} {v}" for k, v in p.sampler_stats.items())
        cut = ("" if method != "dopri5" else
               f" at Qwen {depth[0]} of {V2_QWEN_LAYERS}, DiT {depth[1]} of "
               f"{V2_LAYERS - V2_QWEN_LAYERS}, SigLIP {depth[2]} of 26 layers "
               f"(the same widths), batch 1")
        print(f"[17] sampler {method}, {points}-point grid{cut}: {nfe} "
              f"velocity evaluations{stats}, kernel 1 launches {launches} = "
              f"{depth[0] + depth[1]} x {nfe}; images finite in [-1, 1]; "
              f"{wall:.4f} s a batch of {len(rows)} "
              f"({len(rows) * 60 / wall:.2f} images/min; Euler 50 at full "
              f"depth, batch {V2_BATCH}: {euler_s:.4f} s)")
        out[method] = {"nfe": nfe, "wall_s": wall, **p.sampler_stats}
    stream_counts = {}
    for cache in (False, True):
        p = _v2_variant(pipe, attn_impl="streaming", prefix_cache=cache)
        evals = (1 + V2_EVALS) if cache else V2_EVALS
        want = _v2_want(streaming_attention=V2_LAYERS * evals,
                        streaming_attention_tiles=2 if cache else 1)
        lat, wall, counts = _v2_run(torch, np, cuda_build, p, prompts, z,
                                    want, f"v2 streaming cache={cache}")
        rel = _latent_diff(lat, ref, "v2 streaming vs packed", 17)
        what = " with the prefix cache" if cache else ""
        print(f"[17] route streaming{what}, Euler 50: launches {counts['streaming_attention']} = "
              f"{V2_LAYERS} x {evals} of streaming_attention (kernel 5: "
              f"{V2_QWEN_LAYERS} at D=128, {V2_LAYERS - V2_QWEN_LAYERS} at "
              f"D=64 an evaluation), {counts['streaming_attention_tiles']} "
              f"tile maps, 0 of the others; latents against packed: max "
              f"|d| / peak {rel:.4e} (tol {V2_LATENT_TOL}); {wall:.4f} s "
              f"({V2_BATCH * 60 / wall:.2f} images/min; packed Euler "
              f"{euler_s:.4f} s) on {smi}")
        stream_counts[cache] = counts
        out[f"streaming{'_cached' if cache else ''}"] = {
            "wall_s": wall, "latent_rel_diff": rel}
    out["euler_wall_s"] = euler_s
    return stream_counts[False], stream_counts[True], out


def _v2_prefill(torch, qwen, embeds, bias):
    """One prefill forward of the scaffold's embeddings [1, S, D] by Qwen2
    ``qwen`` (in its dtype) into a fresh cache of an answer's capacity (S +
    MMU_NEW_TOKENS), as MMUV2Pipeline.generate runs it; returns the
    logits of every row."""
    import torch.nn.functional as F

    from showo_tpu_torch.show_o2.qwen2 import Qwen2KVCache

    dtype = qwen.model.embed_tokens.weight.dtype
    S = embeds.shape[1]
    cap = S + MMU_NEW_TOKENS
    cache = Qwen2KVCache.zeros(qwen.cfg, 1, cap, dtype=dtype,
                               device=embeds.device)
    with torch.no_grad():
        return qwen(input_embeds=embeds.to(dtype), cache=cache,
                    attention_bias=F.pad(bias, (0, cap - S), value=-1e9))[0]


def _v2_matmuls(qwen):
    """The matmul modules a token streams: each layer's qkv, o, gate-up
    and down, then the head (int8 ``lm_head``, or the tied embedding)."""
    mods = [m for layer in qwen.model.layers
            for m in (layer.self_attn.qkv, layer.self_attn.o_proj,
                      layer.mlp.gu, layer.mlp.down_proj)]
    return mods + [getattr(qwen, "lm_head", qwen.model.embed_tokens)]


def phase_mmu_v2(torch, cuda_build, profile, pipe, image, int8, smi):
    """Show-o2 image understanding at full width through the pipeline
    ``inference_mmu_v2.build_pipeline`` made: launches over its first greedy
    answer (int8: V2_MATMULS x 101 of kernel 9, the prefill's products on
    the prefill kernel and the decode's on the gemv; bf16: no kernel at
    all; no attention kernel in either), tokens in the vocabulary, VAE
    encode / prompt / prefill times (medians of 3) and one warm answer's,
    decode ms per token against the weight-streaming bound, peak memory,
    and the device's idle share over one answer.  Returns the readings and
    the prompt (embeddings, mask) of phase 18's logits check."""
    from torch import nn

    from showo_tpu_torch.models.phi import Int8Linear
    from showo_tpu_torch.show_o2.showo2 import embed_images

    qwen = pipe.model.showo
    lc = qwen.cfg
    label = f"Show-o2 image understanding, {'int8' if int8 else 'bf16'}"
    linear = Int8Linear if int8 else nn.Linear
    mods = _v2_matmuls(qwen)
    if not (lc.num_layers == V2_QWEN_LAYERS and lc.hidden_size == 1536
            and (lc.num_heads, lc.num_kv_heads, lc.head_dim) == (12, 2, 128)
            and lc.vocab_size == 151940 and lc.tie_word_embeddings
            and pipe.max_new_tokens == MMU_NEW_TOKENS and pipe.top_k == 1
            and pipe.cfg.num_image_tokens == 730
            and pipe.vae.cfg.dim == 96
            and all(isinstance(m, linear) for m in mods[:-1])
            and isinstance(mods[-1], Int8Linear if int8 else nn.Embedding)):
        raise AssertionError(f"{label}: not the full-width fused Qwen2.5 "
                             f"with {linear.__name__} matmuls: {lc}")
    dev = pipe.device
    gen = torch.Generator(device=dev).manual_seed(0)

    def answer():
        return pipe.answer(image, MMU_QUESTION, gen)

    want = {name: 0 for name in COUNTERS}
    if int8:
        want["int8_matmul"] = V2_MATMULS * (1 + MMU_NEW_TOKENS)
        want[PREFILL_KERNEL] = V2_MATMULS
        want["int8_matmul_gemv"] = V2_MATMULS * MMU_NEW_TOKENS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    t0 = time.perf_counter()
    toks = answer()
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    counts = {name: cuda_build.launches[name] for name in want}
    if counts != want:
        raise AssertionError(f"{label}: launches in one answer {counts}, "
                             f"want {want}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not toks or not all(0 <= t < lc.vocab_size for t in toks):
        raise AssertionError(f"{label}: tokens {toks[:8]}... outside the "
                             f"vocabulary, or none")
    pixels = torch.as_tensor(image, device=dev).permute(2, 0, 1)[None, :,
                                                                 None]

    def encode():
        return pipe.encode(pixels, gen)

    def prompt():
        latents = encode()[:, :, 0]
        return pipe.prompt(embed_images(pipe.model, latents),
                           pipe.cfg.num_image_tokens, MMU_QUESTION)

    with torch.no_grad():
        vae_ms = _wall_ms(torch, encode, n=3)
        prompt_ms = _wall_ms(torch, prompt, n=3)
        embeds, bias = prompt()
    rows = embeds.shape[1]
    if rows != V2_PROMPT_ROWS:
        raise AssertionError(f"{label}: {rows} prompt rows, phase 9 timed "
                             f"{V2_PROMPT_ROWS}")
    prefill_ms = _wall_ms(torch, lambda: _v2_prefill(torch, qwen, embeds,
                                                     bias), n=3)
    answer_ms = _wall_ms(torch, answer, n=1)
    decode_ms = (answer_ms - prompt_ms - prefill_ms) / MMU_NEW_TOKENS
    weight_bytes = sum(m.kernel_i8.numel() if int8 else 2 * m.weight.numel()
                       for m in mods)
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    prof = profile(answer, f"[18] {label}: one answer,")
    print(f"[18] {label}: {rows} prompt rows ({pipe.resolution}x"
          f"{pipe.resolution} image, 729 patches + the time token), greedy, "
          f"{MMU_NEW_TOKENS} new tokens ({len(toks)} before the first eos), "
          f"launches per answer {counts['int8_matmul']} of int8_matmul = "
          f"{V2_MATMULS} x {1 + MMU_NEW_TOKENS} ({counts[PREFILL_KERNEL]} on "
          f"the prefill kernel, {counts['int8_matmul_gemv']} on the gemv), 0 "
          f"of the others (attention dense, as JAX); VAE encode "
          f"{vae_ms:.2f} ms (fp32), prompt {prompt_ms:.2f} ms (VAE, "
          f"embedding, scaffold), prefill {prefill_ms:.2f} ms, answer "
          f"{answer_ms:.2f} ms (first {first_wall * 1e3:.2f}; medians of 3 "
          f"/ 3 / 3, one warm answer), decode {decode_ms:.4f} ms per token "
          f"= {1e3 / decode_ms:.2f} tokens/s against a bound of "
          f"{bound_ms:.4f} ms ({weight_bytes / 1e9:.3f} GB of matmul and "
          f"head weights per token over 3.35 TB/s); device idle share over "
          f"one answer {prof['idle_share']:.4f} ({prof['launches']} kernel "
          f"launches), device busy {prof['busy_ms'] / MMU_NEW_TOKENS:.4f} ms "
          f"per token; peak memory allocated {peak:.2f} GiB on {smi}")
    return {"rows": rows, "vae_ms": vae_ms, "prompt_ms": prompt_ms,
            "prefill_ms": prefill_ms, "answer_ms": answer_ms,
            "first_answer_ms": first_wall * 1e3,
            "decode_ms_per_token": decode_ms, "tokens_per_s": 1e3 / decode_ms,
            "bound_ms_per_token": bound_ms, "idle_share": prof["idle_share"],
            "peak_gib": peak, "launches": counts["int8_matmul"],
            "prefill_launches": counts[PREFILL_KERNEL],
            "busy_ms_per_token": prof["busy_ms"] / MMU_NEW_TOKENS
            }, (embeds, bias)


def _int8_in_fp32(torch, qwen32, qwen_i8):
    """``qwen32`` (fp32, fused here) turned into the int8 model computed
    exactly: every matmul weight the int8 model's ``w_i8 * scale`` in
    fp32, and an fp32 ``lm_head`` of its int8 head.  In place."""
    from torch import nn

    from showo_tpu_torch.show_o2.qwen2 import fuse_inference

    fuse_inference(qwen32)
    pairs = [(getattr(a, side), getattr(b, side), name)
             for a, b in zip(qwen32.model.layers, qwen_i8.model.layers)
             for side, names in (("self_attn", ("qkv", "o_proj")),
                                 ("mlp", ("gu", "down_proj")))
             for name in names]
    head = qwen_i8.lm_head
    with torch.no_grad():
        for a, b, name in pairs:
            q = getattr(b, name)
            getattr(a, name).weight.copy_(
                (q.kernel_i8.float() * q.scale.float()).t())
        qwen32.lm_head = nn.Linear(head.in_features, head.out_features,
                                   bias=False, device=head.w_i8.device)
        qwen32.lm_head.weight.copy_(
            (head.kernel_i8.float() * head.scale.float()).t())
    return qwen32


def phase_mmu_v2_parity(torch, pipe_bf, pipe_i8, qwen32, embeds, bias):
    """Prefill logits of one scaffold (the int8 pipeline's embeddings) with
    int8 weights on kernel 9, with bf16 and fp32 weights of the same seeds
    (fp32 activations and full-fp32 matmuls), and with the int8 weights
    computed exactly (in fp32: :func:`_int8_in_fp32`).  Held: int8 on the
    kernel against that exact int8 model, max abs difference over its
    peak below phase 11's INT8_REL and top-1 agreement no more than
    V2_AGREE_SLACK below that of bf16 against fp32 (the kernel's path adds
    no more than bf16 arithmetic does).  Read beside them: int8 against
    fp32, phase 11's pair, and the exact int8 model against fp32 (what the
    quantization alone moves on these random weights)."""
    logits = {name: _v2_prefill(torch, qwen, embeds, bias).float()[0]
              for name, qwen in (("int8", pipe_i8.model.showo),
                                 ("bf16", pipe_bf.model.showo),
                                 ("fp32", qwen32))}
    _int8_in_fp32(torch, qwen32, pipe_i8.model.showo)
    logits["int8 in fp32"] = _v2_prefill(torch, qwen32, embeds,
                                         bias).float()[0]

    def compare(a, b):
        got, ref = logits[a], logits[b]
        agree = (ref.argmax(-1) == got.argmax(-1)).float().mean().item()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        return agree, rel

    readings = {pair: compare(*pair) for pair in (
        ("int8", "int8 in fp32"), ("bf16", "fp32"), ("int8", "fp32"),
        ("int8 in fp32", "fp32"), ("int8", "bf16"))}
    ref = logits["fp32"]
    top2 = ref.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).median().item()
    agree, rel = readings[("int8", "int8 in fp32")]
    floor = readings[("bf16", "fp32")][0] - V2_AGREE_SLACK
    print(f"[18] Show-o2 prefill logits ({qwen32.cfg.num_layers} layers, "
          f"{embeds.shape[1]} rows, vocab {ref.shape[-1]}; fp32 peak |logit| "
          f"{ref.abs().max().item():.3f}, median top-1 margin {margin:.4f}): "
          + "; ".join(f"{a} vs {b} top-1 agreement {g:.4f}, max abs "
                      f"difference / peak {r:.4e}"
                      for (a, b), (g, r) in readings.items())
          + f"; held: int8 vs int8 in fp32 >= {floor:.4f} (bf16 vs fp32 "
          f"less {V2_AGREE_SLACK}) and < {INT8_REL}; int8 vs fp32 read, "
          f"not held (phase 11's {INT8_AGREE} / {INT8_REL}: the exact "
          f"int8 model itself is at the row before)")
    if not (agree >= floor and rel < INT8_REL):
        raise AssertionError(f"v2 int8 vs the int8 model in fp32: agreement "
                             f"{agree} (floor {floor}), relative difference "
                             f"{rel}")
    return {f"{a} vs {b}": {"top1_agreement": g, "max_rel": r}
            for (a, b), (g, r) in readings.items()}


def phase_mmu_vid(torch, cuda_build, inference_mmu_vid, config, smi):
    """Show-o2 video understanding at full width, bf16, through
    ``inference_mmu_vid.build_pipeline``: V2_VIDEO_FRAMES frames made from
    the in-tree image (each shifted a few pixels more than the last) into
    a temporary directory and read back by ``load_video``; the latent
    frames, the prompt rows, one greedy answer's tokens in the vocabulary,
    no kernel launched, its wall time."""
    import tempfile

    from PIL import Image, ImageChops

    from showo_tpu_torch.show_o2.showo2 import embed_images
    from showo_tpu_torch.utils.video import load_video

    pipe = inference_mmu_vid.build_pipeline(config, torch.device("cuda"))
    res = config.dataset.preprocessing.resolution
    if not (pipe.num_frames == V2_VIDEO_FRAMES and res == 432
            and pipe.cfg.llm.num_layers == V2_QWEN_LAYERS
            and not pipe.quantize_int8 and pipe.vae.cfg.dim == 96):
        raise AssertionError(f"not the full-width bf16 video path: "
                             f"{pipe.num_frames} frames at {res}")
    img = Image.open(MMU_IMAGE).convert("RGB")
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(V2_VIDEO_FRAMES):
            ImageChops.offset(img, 6 * i, 3 * i).save(f"{tmp}/{i:02d}.png")
        frames = load_video(tmp, num_frames=pipe.num_frames, resolution=res)
    if frames.shape != (V2_VIDEO_FRAMES, res, res, 3):
        raise AssertionError(f"load_video gave {frames.shape}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    want = {name: 0 for name in COUNTERS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    t0 = time.perf_counter()
    toks = pipe.answer_video(frames, MMU_QUESTION, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: cuda_build.launches[name] for name in want}
    if counts != want:
        raise AssertionError(f"video: launches {counts}, want none")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not toks or not all(0 <= t < pipe.cfg.llm.vocab_size for t in toks):
        raise AssertionError(f"video: tokens {toks[:8]}... outside the "
                             f"vocabulary, or none")
    with torch.no_grad():
        pixels = torch.as_tensor(frames, device=pipe.device).permute(
            3, 0, 1, 2)[None]
        latents = pipe.encode(pixels, gen)
        embeds, _ = pipe.prompt(embed_images(pipe.model, latents),
                                pipe.span(latents.shape[2]), MMU_QUESTION)
    if latents.shape[2] != V2_LATENT_FRAMES:
        raise AssertionError(f"video: {latents.shape[2]} latent frames, "
                             f"want {V2_LATENT_FRAMES}")
    print(f"[18b] Show-o2 video understanding, bf16: {V2_VIDEO_FRAMES} "
          f"frames of {res}x{res} (made from {MMU_IMAGE}, read by "
          f"load_video) -> latents {tuple(latents.shape)} "
          f"({latents.shape[2]} latent frames), {embeds.shape[1]} prompt "
          f"rows (span {pipe.span(latents.shape[2])}), greedy, "
          f"{MMU_NEW_TOKENS} new tokens ({len(toks)} before the first eos) "
          f"in the vocabulary, no kernel launched; one answer "
          f"{wall:.2f} s wall (the first: VAE, SigLIP per frame, prefill, "
          f"decode); peak memory allocated {peak:.2f} GiB on {smi}")
    return {"latent_frames": latents.shape[2], "rows": embeds.shape[1],
            "tokens": len(toks), "wall_s": wall, "peak_gib": peak}


def _t2v_meta(pipe, prompts):
    """(text, spans, route, attention metadata) of one t2v generate of
    ``prompts``: the [cond; null] rows around the video span, cut at its
    end rounded up to 128, and the route ``auto`` picks at their length."""
    from showo_tpu_torch.pipelines.t2i_v2 import attention_inputs

    text, mp = pipe.build_inputs(prompts)
    route = pipe.route(text.shape[1])
    return text, mp, route, attention_inputs(route, text, mp)[1]


def _row_err(got, want, heads):
    """Largest ||got - want|| / ||want|| of a row and head of two [B, S,
    heads * D] attention outputs, taken over the head dim."""
    B, S = want.shape[:2]
    g = got.float().reshape(B, S, heads, -1)
    w = want.float().reshape(B, S, heads, -1)
    den = w.norm(dim=-1).clamp_min(1e-30)
    return ((g - w).norm(dim=-1) / den).max().item()


def phase_t2v_kernel(torch, pipe, prompts, row):
    """Kernel 1 (``t2v``, packed) or kernel 5 (``t2v_long``, streaming)
    against its plain version at the row's shapes: self-attention over the
    [cond; null] rows of one prompt (its video span and the null prompt's),
    Qwen2.5 and DiT heads, through the model's call
    (``qwen2.gqa_attention`` on [B, S, H, D] views, on the tile map the
    generate makes); the map byte for byte; the max abs error (CARD_TOL)
    and the largest error of a row relative to its size (T2V_ROW_TOL); a
    fault planted in the reference (one 64-key tile of the video spans
    masked for every row) must fail the row check; two launches
    bit-identical; median times of kernel, plain version and
    scaled_dot_product_attention with the boolean mask, the device time a
    launch (profiler), the bound; the other of kernels 1 and 5 beside it
    on the same memory, held to both limits (the device time of each at
    the row's length, which ``auto``'s 2816-row cut-over chooses between).
    Returns {label: result, "tiles": the map's result}."""
    import torch.nn.functional as F

    from showo_tpu_torch.ops import flash_attention as tfa
    from showo_tpu_torch.pipelines.t2i_v2 import attention_inputs
    from showo_tpu_torch.ops import streaming_attention as tsa
    from showo_tpu_torch.show_o2 import qwen2 as tqwen2

    phase = T2V_PHASES[row]
    text, mp, route, meta = _t2v_meta(pipe, prompts)
    if route != T2V_ROUTES[row]:
        raise AssertionError(f"{row}: auto picked {route} at "
                             f"{tuple(text.shape)}")
    num = 1 if route == "packed" else 5
    B, L = text.shape
    m = (meta.seg, meta.pad, meta.last_pad, meta.prefix)
    vis = tfa.visible_mask(*m, meta.pos_q)
    n_vis = int(vis.sum())
    meta_bytes = 4 * (4 * B * L + 2 * B)
    print(f"[{phase}] {row}: B={B} S={L} (video spans {mp[:, 0].tolist()}, "
          f"{pipe.num_latent_frames} latent frames); {n_vis} visible (row, "
          f"key) pairs of {B * L * L} ({n_vis / (B * L * L):.4f})")
    make = tfa.rows_tile_map if route == "packed" else tsa.streaming_tile_map
    tiles, maps = _map_check(
        torch, f"kernel {num}'s tile map {tuple(meta.tiles.shape)}",
        lambda: make(*m, meta.pos_q, meta.seg_q),
        lambda: tfa.rows_tile_map_plain(*m, meta.pos_q),
        meta_bytes + meta.tiles.numel(), B * (-(-L // 64) * 64) ** 2, phase,
        flag=True)
    if not torch.equal(tiles, meta.tiles):
        raise AssertionError(f"{row}: the map the model reads differs")
    # the planted fault: the first whole 64-key tile inside every video span
    # masked for every row (each row still sees its text prefix)
    drop = (int(mp[:, 0, 0].max()) // 64 + 1) * 64
    if not drop + 64 <= int(mp[:, 0].sum(-1).min()):
        raise AssertionError(f"{row}: no whole key tile inside the spans")
    vis_fault = vis.clone()
    vis_fault[:, :, drop:drop + 64] = False
    other = "streaming" if route == "packed" else "packed"
    other_meta = attention_inputs(other, text, mp)[1]
    g = torch.Generator(device="cuda").manual_seed(51)
    out = {"tiles": maps}
    for label, H, Hkv, D in V2_SHAPES:
        q = torch.randn(B, L, H, D, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(B, L, Hkv, D, generator=g, device="cuda")
                .bfloat16() for _ in range(2))
        heads = [t.transpose(1, 2) for t in (q, k, v)]
        shape = f"{label}: B={B} S={L} H={H} Hkv={Hkv} D={D}"
        bound = _bound(2 * (2 * B * L * H + 2 * B * L * Hkv) * D + meta_bytes,
                       4 * D * H * n_vis)

        def kern():
            return tqwen2.gqa_attention(q, k, v, None, meta)

        def plain():
            if route == "streaming":
                return tsa.omni_attention_streaming_plain(
                    *heads, *m, meta.pos_q, sm_scale=D ** -0.5).transpose(
                        1, 2).reshape(B, L, H * D)
            return tfa.omni_attention_packed_plain(
                q.reshape(B, L, -1), k.reshape(B, L, -1), v.reshape(B, L, -1),
                *m, meta.pos_q, num_heads=H, num_kv_heads=Hkv,
                sm_scale=D ** -0.5)

        def sdpa(mask=vis):
            return F.scaled_dot_product_attention(
                *heads, attn_mask=mask[:, None], enable_gqa=Hkv != H)

        res = _compare(torch, f"kernel {num} {shape}", kern, plain, bound,
                       sdpa, phase=phase)
        got = kern()
        if not torch.equal(got, kern()):
            raise AssertionError(f"{shape} kernel {num}: two launches differ")
        row_err = _row_err(got, plain(), H)
        faulty = sdpa(vis_fault).transpose(1, 2).reshape(B, L, H * D)
        fault_row = _row_err(got, faulty, H)
        fault_abs = (got.float() - faulty.float()).abs().max().item()
        del faulty

        def beside():
            return tqwen2.gqa_attention(q, k, v, None, other_meta)

        near = beside()
        diff = (near.float() - got.float()).abs().max().item()
        diff_row = _row_err(near, got, H)
        del near
        print(f"[{phase}] kernel {num} {shape}: largest error of a row "
              f"relative to its size {row_err:.3e} (tol {T2V_ROW_TOL:.0e}); "
              f"planted fault (key tile {drop}-{drop + 63} masked in the "
              f"reference) {fault_row:.3e}, failing it, max abs "
              f"{fault_abs:.3e} (tol {CARD_TOL:.0e})")
        if not (row_err <= T2V_ROW_TOL and fault_row > T2V_ROW_TOL):
            raise AssertionError(f"{shape} kernel {num}: row error {row_err}, "
                                 f"planted fault {fault_row} (tol "
                                 f"{T2V_ROW_TOL})")
        if not (diff <= CARD_TOL and diff_row <= T2V_ROW_TOL):
            raise AssertionError(f"{shape}: the {other} kernel differs by "
                                 f"{diff} (row {diff_row})")
        res.update({"row_err": row_err, "planted_fault_row": fault_row,
                    "planted_fault_abs": fault_abs,
                    "device_ms": _device_ms(torch, kern),
                    "library_device_ms": _device_ms(torch, sdpa),
                    "beside": {"route": other, "max_diff": diff,
                               "row_diff": diff_row,
                               "device_ms": _device_ms(torch, beside)}})
        print(f"[{phase}] kernel {num} {shape}: two launches bit-identical; "
              f"device time a launch (profiler, mean of 20) "
              f"{_ms(res['device_ms'])}, library "
              f"{_ms(res['library_device_ms'])}; beside it on the same "
              f"memory the {other} kernel ({6 - num}) "
              f"{_ms(res['beside']['device_ms'])}, max |difference| "
              f"{diff:.3e} (tol {CARD_TOL:.0e}), of a row {diff_row:.3e} "
              f"(tol {T2V_ROW_TOL:.0e})")
        out[label] = res
        del q, k, v, heads, got
        torch.cuda.empty_cache()
    return out


def phase_t2v(torch, np, cuda_build, pipe, prompts, row, smi):
    """bench.py's ``row`` through ``T2VPipeline``: over one generate the
    row's kernel launches 38 x 19 times (every layer of both towers, each
    velocity evaluation; on ``packed`` all on the wgmma core), reading one
    tile map, and every other kernel none; frames finite, NHWC, in [-1, 1];
    warm seconds of the denoise and of the decode (streamed at 9 latent
    frames), frames/min, peak memory.  Returns (counts, readings)."""
    phase, route = T2V_PHASES[row], T2V_ROUTES[row]
    frames = T2V_FRAMES[row]
    text, _, picked, _ = _t2v_meta(pipe, prompts)
    if not (_v2_full_width(pipe) and picked == route
            and pipe.num_latent_frames == frames
            and pipe.num_steps == T2V_STEPS
            and pipe.guidance_scale == T2V_CFG
            and pipe.streams_vae == (frames >= 9)):
        raise AssertionError(f"{row}: not bench.py's row at full width: "
                             f"{picked}, {frames} frames, {pipe.cfg}")
    name = KERNELS[route][0]
    want = _v2_want(**{name: V2_LAYERS * T2V_EVALS, ROUTE_TILES[route]: 1})
    if route == "packed":
        want[PACKED_WGMMA] = V2_LAYERS * T2V_EVALS
    gen = torch.Generator(device="cuda").manual_seed(0)
    pipe.generate(prompts, gen)                                # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    t0 = time.perf_counter()
    lat = pipe.generate_latents(prompts, gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    videos = pipe.decode(lat)
    t2 = time.perf_counter()
    counts = {n: cuda_build.launches[n] for n in want}
    if counts != want:
        raise AssertionError(f"{row}: launches in one generate {counts}, "
                             f"want {want}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pix = 4 * (frames - 1) + 1
    if videos.shape != (len(prompts), pix, 432, 432, 3) or not np.isfinite(
            videos).all() or videos.min() < -1.0 or videos.max() > 1.0:
        raise AssertionError(f"{row}: frames {videos.shape}, not finite or "
                             f"outside [-1, 1]")
    wall = t2 - t0
    print(f"[{phase}] slice Show-o2 1.5B {row} 432x432: {len(prompts)} "
          f"prompt, {frames} latent frames -> {pix} frames, Euler "
          f"{T2V_STEPS} ({T2V_EVALS} velocity evaluations), CFG {T2V_CFG} "
          f"({tuple(text.shape)} rows x tokens), bf16, VAE fp32 "
          f"({'streaming' if pipe.streams_vae else 'full-clip'} decode; "
          f"cuDNN TF32 {torch.backends.cudnn.allow_tf32}, matmul TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}), route {route}: "
          f"launches per generate {counts[name]} = {V2_LAYERS} x "
          f"{T2V_EVALS} of {name}"
          + (f" ({counts[PACKED_WGMMA]} on the wgmma core)"
             if route == "packed" else "")
          + f", {counts[ROUTE_TILES[route]]} tile map, 0 of the others; "
          f"frames {videos.shape} finite in [-1, 1]; warm wall {wall:.4f} s "
          f"(denoise {t1 - t0:.4f} s, decode {t2 - t1:.4f} s), "
          f"{pix * len(prompts) * 60.0 / wall:.2f} frames/min; peak memory "
          f"allocated {peak:.2f} GiB on {smi}")
    return counts, {"wall_s": wall, "denoise_s": t1 - t0,
                    "decode_s": t2 - t1, "rows": text.shape[1],
                    "frames_per_min": pix * len(prompts) * 60.0 / wall,
                    "peak_gib": peak}


def phase_t2v_parity(torch, pipe, prompts, row):
    """One full-width video velocity evaluation on the row's route against
    a reference route on the same weights, latents and t: ``dense`` where
    its fp32 scores fit the card, else ``packed`` (held to dense in phase
    19); unguided.  Returns (reference route, max |dv| / peak)."""
    from showo_tpu_torch.pipelines.t2i_v2 import attention_inputs
    from showo_tpu_torch.show_o2.showo2 import showo2_t2i_velocity

    phase = T2V_PHASES[row]
    text, mp, route, meta = _t2v_meta(pipe, prompts)
    cfg = pipe.cfg
    g = torch.Generator(device="cuda").manual_seed(61)
    z = torch.randn(1, cfg.image_latent_dim, pipe.num_latent_frames,
                    cfg.image_latent_height, cfg.image_latent_width,
                    generator=g, device="cuda")
    x = z.expand(text.shape[0], -1, -1, -1, -1)
    t = torch.full((text.shape[0],), 0.5, device="cuda")

    def velocity(bias, attn_meta):
        with torch.no_grad():
            return showo2_t2i_velocity(
                pipe.model, text, x, t, bias, mp,
                num_frames=pipe.num_latent_frames,
                attn_meta=attn_meta).float()

    v = velocity(None, meta)
    ref = "dense"
    try:
        want = velocity(attention_inputs("dense", text, mp)[0], None)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        ref = "packed"
        want = velocity(None, attention_inputs("packed", text, mp)[1])
    rel = ((v - want).abs().max() / want.abs().max()).item()
    print(f"[{phase}] {row} velocity parity {route} vs {ref} (28 + 10 "
          f"layers, {tuple(text.shape)}, {pipe.num_latent_frames} latent "
          f"frames, bf16, t 0.5, unguided): max |dv| / peak {rel:.4e} "
          f"(peak |v| {want.abs().max().item():.4f}; tol {V2_STEP_TOL})"
          + ("" if ref == "dense" else "; dense did not fit the card"))
    if not rel <= V2_STEP_TOL:
        raise AssertionError(f"{row}: velocity {route} vs {ref} differs by "
                             f"{rel} of the peak > {V2_STEP_TOL}")
    del v, want
    torch.cuda.empty_cache()
    return ref, rel


def phase_i2v(torch, cuda_build, pipe, prompts, smi):
    """An i2v generate at the t2v row's size: the in-tree image at 432x432
    through the VAE encoder as the first frame (its noise drawn from the
    generator after z); the first latent frame must come out as the encoder
    gave it (its velocity is zero at every step) and the other frames must
    move; the same launches as t2v."""
    cfg = pipe.cfg
    image = _mmu_image(432)
    seed = 71
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (len(prompts), cfg.image_latent_dim, pipe.num_latent_frames,
             cfg.image_latent_height, cfg.image_latent_width)
    z = torch.randn(shape, generator=g, device="cuda")
    frame0 = pipe.encode_first_frame(image, len(prompts), g)
    want = _v2_want(**{"omni_attention_packed": V2_LAYERS * T2V_EVALS,
                       PACKED_WGMMA: V2_LAYERS * T2V_EVALS, PACKED_TILES: 1})
    torch.cuda.synchronize()
    cuda_build.launches.clear()
    t0 = time.perf_counter()
    lat = pipe.generate_latents(
        prompts, torch.Generator(device="cuda").manual_seed(seed),
        first_frame_nhwc=image)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: cuda_build.launches[n] for n in want}
    if counts != want:
        raise AssertionError(f"i2v: launches {counts}, want {want}")
    kept = (lat[:, :, 0] - frame0[:, :, 0]).abs().max().item()
    moved = (lat[:, :, 1:] - z[:, :, 1:]).abs().max().item()
    print(f"[19] i2v at the t2v size: the first frame ({MMU_IMAGE} at "
          f"432x432) encoded to {tuple(frame0.shape)}; after {T2V_EVALS} "
          f"Euler steps the first latent frame differs from it by "
          f"{kept:.3e} (tol 1e-5: its velocity is zero, and the encoder "
          f"ran twice on one draw), the others moved "
          f"from z by up to {moved:.3f}; launches "
          f"{counts['omni_attention_packed']} of omni_attention_packed, "
          f"{counts[PACKED_TILES]} tile map; denoise {wall:.4f} s (with the "
          f"encode) on {smi}")
    if not (kept <= 1e-5 and moved > 1e-2):
        raise AssertionError(f"i2v: first frame off by {kept}, others moved "
                             f"{moved}")
    return {"first_frame_diff": kept, "wall_s": wall}


def phase_vae_streaming(torch, pipe, smi):
    """The streaming decode of 9 latent frames against the full-clip
    decode on the card (fp32, cuDNN TF32 off for the comparison: both
    orders of the same fp32 sums), and their times."""
    from showo_tpu_torch.show_o2.wan_vae import (wan_decode,
                                                 wan_decode_streaming)

    g = torch.Generator(device="cuda").manual_seed(81)
    cfg = pipe.cfg
    z = torch.randn(1, cfg.image_latent_dim, T2V_FRAMES["t2v_long"],
                    cfg.image_latent_height, cfg.image_latent_width,
                    generator=g, device="cuda")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            times, out, peaks = {}, {}, {}
            for name, fn in (("full", wan_decode),
                             ("streaming", wan_decode_streaming)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out[name] = fn(pipe.vae, z)
                torch.cuda.synchronize()
                times[name] = time.perf_counter() - t0
                peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    err = (out["streaming"] - out["full"]).abs().max().item()
    print(f"[19b] Wan2.1 VAE decode of {T2V_FRAMES['t2v_long']} latent "
          f"frames -> {tuple(out['full'].shape)} (fp32, cuDNN TF32 off for "
          f"this check): streaming vs full clip max |d| {err:.3e} (tol "
          f"{VAE_STREAM_TOL:.0e}); full clip {times['full']:.3f} s, peak "
          f"{peaks['full']:.2f} GiB; streaming {times['streaming']:.3f} s, "
          f"peak {peaks['streaming']:.2f} GiB (first calls) on {smi}")
    if not err <= VAE_STREAM_TOL:
        raise AssertionError(f"streaming decode differs by {err}")
    return {"max_abs_err": err, "full_s": times["full"],
            "streaming_s": times["streaming"], "full_peak_gib": peaks["full"],
            "streaming_peak_gib": peaks["streaming"]}


def phase_mixed(torch, np, cuda_build, profile, pipe, smi):
    """Show-o2 mixed-modality generation at full width: MIXED_ROUNDS rounds
    of up to MIXED_TOKENS top-k 5 tokens and an image each (Euler
    T2V_STEPS, CFG T2V_CFG, the earlier images as history, dense attention
    as in JAX: no kernel); round texts in the vocabulary, images finite in
    [-1, 1], one per round that did not end in eos; decode ms per token and
    the prefill of one round's text timed apart, and the device's idle
    share over it (a profiled run of its own), seconds per image."""
    ids = pipe.token_ids
    if not (_v2_full_width(pipe) and pipe.num_steps == T2V_STEPS
            and pipe.guidance_scale == T2V_CFG
            and pipe.max_new_tokens == MIXED_TOKENS and pipe.top_k == 5):
        raise AssertionError(f"mixed modality: not the full-width path: "
                             f"{pipe.cfg}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    want = _v2_want()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    t0 = time.perf_counter()
    rounds, images = pipe.generate(MIXED_PROMPT, gen, num_rounds=MIXED_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: cuda_build.launches[n] for n in want}
    if counts != want:
        raise AssertionError(f"mixed modality: launches {counts}, want none")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    vocab = pipe.cfg.llm.vocab_size
    n_img = sum(1 for r in rounds if r and r[-1] != ids["eos_id"])
    if not (rounds and all(0 <= t < vocab for r in rounds for t in r)
            and images.shape == (n_img, 432, 432, 3)
            and np.isfinite(images).all() and images.min() >= -1.0
            and images.max() <= 1.0 and n_img >= 1):
        raise AssertionError(f"mixed modality: rounds "
                             f"{[len(r) for r in rounds]}, images "
                             f"{images.shape}")
    texts = [pipe.tokenizer.decode(r) for r in rounds]
    # one round's text again, timed without the profiler: the prefill and
    # n decode forwards over the KV cache (ar_generate runs all n), n = 1
    # and MIXED_TOKENS, median of 3 each; a decode forward is the
    # difference over MIXED_TOKENS - 1, the prefill what n = 1 adds to one
    prompt = [ids["bos_id"]] + pipe._tok(MIXED_PROMPT)
    walls = {}
    try:
        for n in (1, MIXED_TOKENS):
            pipe.max_new_tokens = n
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pipe.lm_generate(prompt, gen)
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            walls[n] = statistics.median(runs)
    finally:
        pipe.max_new_tokens = MIXED_TOKENS
    token_ms = (walls[MIXED_TOKENS] - walls[1]) * 1e3 / (MIXED_TOKENS - 1)
    prefill_ms = walls[1] * 1e3 - token_ms
    # and profiled, for the device's idle share only
    prof = profile(lambda: pipe.lm_generate(prompt, gen),
                   "[20] mixed modality: one round's text,")
    # one image: the first round's layout, denoised and decoded
    n = pipe.cfg.num_image_tokens
    toks = prompt + rounds[0] + ([] if rounds[0][-1] == ids["boi_id"]
                                 else [ids["boi_id"]])
    mp = torch.tensor([[[len(toks), n]]], device="cuda")
    toks = toks + [ids["img_pad_id"]] * n + [ids["eoi_id"]]
    hist = torch.zeros((0, 16, 54, 54), device="cuda")
    t0 = time.perf_counter()
    pipe.decode(pipe.denoise_last(torch.tensor([toks], device="cuda"), mp,
                                  hist, gen))
    torch.cuda.synchronize()
    image_s = time.perf_counter() - t0
    print(f"[20] Show-o2 mixed modality 432x432, bf16, VAE fp32: "
          f"{len(rounds)} rounds of {[len(r) for r in rounds]} tokens "
          f"(top-k 5, up to {MIXED_TOKENS}) and {n_img} images (Euler "
          f"{T2V_STEPS}, CFG {T2V_CFG}, dense attention, 0 kernel launches) "
          f"in {wall:.2f} s (the first call); round texts "
          f"{[t[:40] for t in texts]}; images {images.shape} finite in "
          f"[-1, 1]; one round's text ({len(prompt)} prompt tokens, "
          f"{MIXED_TOKENS} new; median of 3, no profiler) "
          f"{walls[MIXED_TOKENS]:.4f} s: decode {token_ms:.4f} ms per "
          f"token, prefill {prefill_ms:.4f} ms; device idle share "
          f"{prof['idle_share']:.4f} over it (profiled run, "
          f"{prof['launches']} kernel launches); one image (the first round's, {len(toks)} rows) "
          f"{image_s:.3f} s with its decode; peak memory allocated "
          f"{peak:.2f} GiB on {smi}")
    return {"rounds": [len(r) for r in rounds], "images": n_img,
            "wall_s": wall, "decode_ms_per_token": token_ms,
            "prefill_ms": prefill_ms, "text_s": walls[MIXED_TOKENS],
            "idle_share": prof["idle_share"], "s_per_image": image_s,
            "peak_gib": peak}


def phase_lvg(torch, np, cuda_build, inference_lvg, inference_t2i, smi):
    """Show-o v1 long-video generation at full width (configs/showo_demo
    .yaml, 256x256, Phi-1.5 and the full MAGVIT-v2, bf16 / fp32) through
    ``inference_lvg.build_pipeline``: LVG_BATCH prompts, LVG_FRAMES frames
    with LVG_CONTEXT context frames, 16 MaskGIT steps, CFG 1.75, dense
    attention under the lvg mask as in JAX (no kernel); codes in the
    codebook, frames finite, the frames that differ from the one before,
    seconds per frame."""
    from showo_tpu_torch.config import load_config

    config = load_config("configs/showo_demo.yaml",
                         [f"context_frames={LVG_CONTEXT}"])
    pipe = inference_lvg.build_pipeline(config, torch.device("cuda"))
    cfg, lc = pipe.cfg, pipe.cfg.llm
    if not (lc.num_layers == NUM_LAYERS and lc.hidden_size == 2048
            and cfg.num_vq_tokens == 256 and cfg.codebook_size == 8192
            and pipe.timesteps == TIMESTEPS and pipe.guidance_scale == 1.75
            and pipe.context_frames == LVG_CONTEXT):
        raise AssertionError(f"lvg: not the full-width demo path: {cfg}")
    prompts = inference_t2i.load_prompts(config)[:LVG_BATCH]
    gen = torch.Generator(device="cuda").manual_seed(0)
    pipe.generate_codes(prompts, 1, gen)                       # warm-up
    want = _v2_want()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    t0 = time.perf_counter()
    frames = pipe.generate_codes(prompts, LVG_FRAMES, gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    video = pipe.decode(frames)
    t2 = time.perf_counter()
    counts = {n: cuda_build.launches[n] for n in want}
    if counts != want:
        raise AssertionError(f"lvg: launches {counts}, want none")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (all(c.shape == (LVG_BATCH, 256) and c.min() >= 0
                and c.max() < cfg.codebook_size for c in frames)
            and video.shape == (LVG_BATCH, LVG_FRAMES, 256, 256, 3)
            and np.isfinite(video).all()):
        raise AssertionError(f"lvg: codes or frames {video.shape} malformed")
    differ = sum(int(not np.array_equal(frames[f][b], frames[f - 1][b]))
                 for b in range(LVG_BATCH) for f in range(1, LVG_FRAMES))
    # the text block, then a span of soi, 256 codes, eoi a frame
    rows = [pipe.uni_prompting.max_text_len
            + (min(f, LVG_CONTEXT) + 1) * (cfg.num_vq_tokens + 2)
            for f in range(LVG_FRAMES)]
    if differ != LVG_BATCH * (LVG_FRAMES - 1):
        raise AssertionError(f"lvg: only {differ} frames differ from the one "
                             f"before")
    print(f"[21] Show-o v1 lvg 256x256: batch {LVG_BATCH}, {LVG_FRAMES} "
          f"frames, {LVG_CONTEXT} context frames, {TIMESTEPS} MaskGIT steps, "
          f"CFG 1.75, bf16, dense attention under the lvg mask (0 kernel "
          f"launches); rows a frame {rows}; codes in the "
          f"codebook, frames {video.shape} finite; {differ} of "
          f"{LVG_BATCH * (LVG_FRAMES - 1)} frames differ from the one before;"
          f" {(t1 - t0) / LVG_FRAMES:.3f} s a frame of the batch (MaskGIT), "
          f"decode {t2 - t1:.3f} s; peak memory allocated {peak:.2f} GiB on "
          f"{smi}")
    return {"s_per_frame": (t1 - t0) / LVG_FRAMES, "decode_s": t2 - t1,
            "frames_differ": differ, "peak_gib": peak}


class _ServeProbe:
    """Host-side instruments of one engine: the kernel 9 launches of each
    prefill, fused admission and decode dispatch (counter deltas around the
    call: no device sync), and a snapshot of a request's lane cache rows
    (prompt and fed tokens, device copies) when it finishes."""

    NAMES = ("int8_matmul", PREFILL_KERNEL, "int8_matmul_gemv",
             "int8_matmul_mma")

    def __init__(self, cuda_build, server):
        self.cb, self.eng = cuda_build, server.engine
        self.calls = {"decode": [], "prefill": [], "fused": []}
        self.snaps = {}
        eng = self.eng
        eng._decode_chunk = self._wrap("decode", eng._decode_chunk)
        if eng._alt_decode_chunk is not None:
            eng._alt_decode_chunk = self._wrap("decode",
                                               eng._alt_decode_chunk)
        for kind, attr in (("prefill", "_prefill_for"),
                           ("fused", "_fused_admit_for")):
            make = getattr(eng, attr)
            if make is not None:
                setattr(eng, attr, lambda b, m=make, k=kind: self._wrap(
                    k, m(b)))
        eng._prefill_cache.clear()
        eng._fused_cache.clear()
        finish = eng._finish_check

        def finish_check(r, now):
            done = finish(r, now)
            if done and r.uid not in self.snaps:
                s = eng.active.index(r)
                n = len(r.prompt) + len(r.tokens) - 1
                self.snaps[r.uid] = tuple(c[:, s, :n].clone()
                                          for c in (eng.cache_k,
                                                    eng.cache_v))
            return done

        eng._finish_check = finish_check

    def _wrap(self, kind, fn):
        def run(*args):
            before = [self.cb.launches[n] for n in self.NAMES]
            out = fn(*args)
            self.calls[kind].append(tuple(
                self.cb.launches[n] - b for n, b in zip(self.NAMES, before)))
            return out
        return run

    def reset(self):
        for v in self.calls.values():
            v.clear()
        self.snaps.clear()
        eng = self.eng
        eng.stat_steps = eng.stat_windows = eng.stat_syncs = 0
        eng.stat_lane_steps = eng.stat_step_tokens = 0

    def per_call(self, kind, matmuls, label, per=1):
        """Check every call of ``kind`` launched ``per`` x ``matmuls``
        kernel 9 products (decode: per = the chunk's steps) and return the
        cores' split of one call."""
        calls = self.calls[kind]
        bad = [c for c in calls if c[0] != per * matmuls or c[3]]
        if bad:
            raise AssertionError(f"{label}: {kind} calls launched {bad[:3]} "
                                 f"(int8_matmul, prefill core, gemv, mma), "
                                 f"want {per * matmuls} products and no mma")
        return calls[0] if calls else None


def _rel_rows(torch, got, want):
    """The largest ||got - want|| / ||want|| over the rows [L, n, ...]."""
    d = (got.float() - want.float()).flatten(2).norm(dim=-1)
    return (d / want.float().flatten(2).norm(dim=-1).clamp(min=1e-6)).max(
        ).item()


def _teacher_forced(torch, ref_fn, handles, snaps, sampling, label):
    """Hold each request's engine tokens (and its lane cache rows, where
    snapped) to the single-request model: ``ref_fn(request)`` -> (logits
    [T, V] predicting each engine token, the reference cache (k, v) [L,
    rows, ...]).  Returns the readings; raises nothing (the caller holds
    them to the limits)."""
    from showo_tpu_torch.sampling.ar import filter_logits

    worst_gap, exact, outside, worst_row, n_tok = 0.0, 0, 0, 0.0, 0
    for h in handles:
        logits, (rk, rv) = ref_fn(h)
        toks = torch.tensor(h.tokens, device=logits.device)
        picked = logits.gather(1, toks[:, None])[:, 0]
        n_tok += len(h.tokens)
        if sampling is None:
            worst_gap = max(worst_gap, (logits.max(-1).values - picked).max(
                ).item())
            exact += int(torch.equal(logits.argmax(-1), toks))
        else:
            temperature, top_k, top_p = sampling
            flog = filter_logits(logits, temperature, top_k,
                                 top_p + NUCLEUS_SLACK)
            outside += int((~torch.isfinite(flog.gather(
                1, toks[:, None]))).sum().item())
        if h.uid in snaps:
            ek, ev = snaps[h.uid]
            n = ek.shape[1]
            worst_row = max(worst_row, _rel_rows(torch, ek, rk[:, :n]),
                            _rel_rows(torch, ev, rv[:, :n]))
    ok = (worst_row <= CACHE_ROW_TOL and (
        worst_gap <= GREEDY_LOGIT_TOL if sampling is None else outside == 0))
    return {"ok": ok, "max_logit_gap": worst_gap, "exact_requests": exact,
            "requests": len(handles), "tokens": n_tok,
            "tokens_outside_nucleus": outside, "max_cache_row_err": worst_row,
            "cache_checked": sum(h.uid in snaps for h in handles),
            "label": label}


def _tf_line(r, sampling) -> str:
    tok = (f"largest gap to the reference's top logit {r['max_logit_gap']:.4f}"
           f" (limit {GREEDY_LOGIT_TOL}), {r['exact_requests']} of "
           f"{r['requests']} requests token-exact against the reference's "
           f"argmax" if sampling is None else
           f"{r['tokens_outside_nucleus']} tokens outside the reference's "
           f"nucleus at top_p {sampling[2]} + {NUCLEUS_SLACK}")
    return (f"{r['tokens']} tokens of {r['requests']} requests: {tok}; lane "
            f"cache rows of {r['cache_checked']} requests, largest row error "
            f"{r['max_cache_row_err']:.3e} (limit {CACHE_ROW_TOL})")


def _v1_reference(torch, phi, eoi):
    """ref_fn of :func:`_teacher_forced` for Show-o v1: the prompt's
    prefill as ``showo_mmu_generate`` runs it (the mmu mask padded with
    -1e9 to a cache of prompt + tokens rows), then one cached forward of
    the engine's tokens but the last (row r sees the cache up to S + r)."""
    import torch.nn.functional as F

    from showo_tpu_torch.models.phi import KVCache
    from showo_tpu_torch.ops.masks import omni_mask_mmu

    def ref(h):
        emb = phi.model.embed_tokens.weight
        ids = torch.as_tensor(h.prompt, device=emb.device).long()[None]
        S, T = ids.shape[1], len(h.tokens)
        cap = S + T
        cache = KVCache.zeros(phi.cfg, 1, cap, dtype=emb.dtype,
                              device=emb.device)
        bias = F.pad(omni_mask_mmu(ids, eoi_id=eoi), (0, cap - S), value=-1e9)
        rows = [phi(input_ids=ids, attention_bias=bias, cache=cache,
                    lm_head_slice=(S - 1, S, None, None))[0][0]]
        if T > 1:
            toks = torch.tensor(h.tokens[:-1], device=emb.device)[None]
            kpos = torch.arange(cap, device=emb.device)
            r = torch.arange(T - 1, device=emb.device)[:, None]
            b = torch.where(kpos < S + r + 1, 0.0, -1e9)[None, None]
            rows.append(phi(input_ids=toks, attention_bias=b,
                            cache=cache)[0][0])
        return torch.cat(rows).float(), (cache.k[:, 0], cache.v[:, 0])

    return ref


def _v2_reference(torch, qwen, n_img):
    """The same for Show-o2: the embeddings' prefill under the v2 omni mask
    (the span at its ``img_start``), as ``MMUV2Pipeline.generate`` runs
    it, then one cached forward of the engine's tokens."""
    import torch.nn.functional as F

    from showo_tpu_torch.serving.decode_chunk import qwen_logits
    from showo_tpu_torch.show_o2.masks import omni_attn_mask
    from showo_tpu_torch.show_o2.qwen2 import Qwen2KVCache

    def ref(h):
        emb = h.prompt[None]
        dev, dtype = emb.device, qwen.model.embed_tokens.weight.dtype
        S, T = emb.shape[1], len(h.tokens)
        cap = S + T
        cache = Qwen2KVCache.zeros(qwen.cfg, 1, cap, dtype=dtype, device=dev)
        mp = torch.tensor([[[h.meta[0], n_img]]], device=dev)
        bias = F.pad(omni_attn_mask(mp, S), (0, cap - S), value=-1e9)
        _, hid = qwen(input_embeds=emb.to(dtype), attention_bias=bias,
                      cache=cache, logits=False)
        rows = [qwen_logits(qwen, hid[0, -1:])]
        if T > 1:
            toks = torch.tensor(h.tokens[:-1], device=dev)[None]
            kpos = torch.arange(cap, device=dev)
            r = torch.arange(T - 1, device=dev)[:, None]
            b = torch.where(kpos < S + r + 1, 0.0, -1e9)[None, None]
            rows.append(qwen(input_ids=toks, attention_bias=b,
                             cache=cache)[0][0])
        return torch.cat(rows).float(), (cache.k[:, 0], cache.v[:, 0])

    return ref


def _serve_run(torch, cuda_build, server, probe, submits, generator):
    """One timed drain of the server: every launch count set to 0 just
    before, read just after; tokens/s over the wall, TTFT p50 / p95."""
    import numpy as np

    probe.reset()
    handles = [submit() for submit in submits]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    t0 = time.perf_counter()
    done = server.run(generator)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(cuda_build.launches)
    if len(done) != len(handles):
        raise AssertionError(f"{len(done)} of {len(handles)} requests done")
    ttft = np.asarray([h.first_token_at - h.submitted_at for h in handles])
    return handles, {
        "seconds": wall, "tokens": sum(len(h.tokens) for h in handles),
        "tokens_per_s": sum(len(h.tokens) for h in handles) / wall,
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p95_s": float(np.percentile(ttft, 95)),
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": counts}


def _serve_row(torch, cuda_build, profile, server, probe, label, phase,
               submits, budgets, sampling, spec, matmuls, ref_fn, window_req,
               smi):
    """One bench row through the server: the timed drain, its checks (every
    budget met with ids in the vocabulary, kernel 9 launches a decode step
    / prefill / admission, no other kernel, the teacher-forced check), then
    one profiled decode window (of one chunk) of SERVE_SLOTS fresh
    requests."""
    eng = server.engine
    gen = torch.Generator(device=eng.device).manual_seed(1)
    handles, run = _serve_run(torch, cuda_build, server, probe, submits, gen)
    vocab = (server.phi if hasattr(server, "phi") else server.qwen).cfg
    vocab = vocab.vocab_size
    for h, b in zip(handles, budgets):
        if len(h.tokens) != b or not all(0 <= t < vocab for t in h.tokens):
            raise AssertionError(f"[{phase}] {label}: request {h.uid} gave "
                                 f"{len(h.tokens)} tokens for a budget of "
                                 f"{b}, or ids outside the vocabulary")
    others = {n: c for n, c in run["launches"].items()
              if c and not n.startswith("int8_matmul")}
    if others or not run["launches"].get("int8_matmul"):
        raise AssertionError(f"[{phase}] {label}: kernel launches {others} "
                             f"besides kernel 9, or none of kernel 9")
    dec = probe.per_call("decode", matmuls, label, per=SERVE_CHUNK)
    pre = probe.per_call("prefill", matmuls, label)
    fus = probe.per_call("fused", matmuls, label)
    steps, windows, syncs = eng.stat_steps, eng.stat_windows, eng.stat_syncs
    tf = _teacher_forced(torch, ref_fn, handles, probe.snaps, sampling, label)
    if not tf["ok"] or syncs != windows:
        raise AssertionError(f"[{phase}] {label}: {syncs} host syncs in "
                             f"{windows} windows, or the teacher-forced "
                             f"check failed: {_tf_line(tf, sampling)}")
    probe.snaps.clear()
    lane_tokens = eng.stat_step_tokens / max(1, eng.stat_lane_steps)
    # one decode window (of one chunk) of SERVE_SLOTS fresh requests,
    # profiled
    for submit in window_req:
        submit()
    eng._fill_slots(gen)
    torch.cuda.synchronize()
    eng.lookahead = 1
    prof = profile(lambda: eng._decode_once(gen, []),
                   f"[{phase}] {label}: one decode window of one chunk,")
    eng.lookahead = SERVE_LOOKAHEAD
    server.run(gen)
    ab = (f"; A/B choice {eng.ab_choice} (trace {eng.ab_trace[:4]})"
          if eng._alt_decode_chunk is not None else "")
    drafts = (f"; tokens a lane step {lane_tokens:.4f}, share of drafts "
              f"accepted {(lane_tokens - 1) / spec:.4f}"
              + (" (both programs' windows)" if ab else "")
              if spec else "")
    cores = lambda c: ("none" if c is None else
                       f"{c[0]} ({c[1]} prefill core, {c[2]} gemv)")
    print(f"[{phase}] {label}: {len(handles)} requests, {run['tokens']} "
          f"tokens in {run['seconds']:.3f} s = {run['tokens_per_s']:.2f} "
          f"tokens/s; TTFT p50 {run['ttft_p50_s']:.3f} s, p95 "
          f"{run['ttft_p95_s']:.3f} s; {steps} decode steps in {windows} "
          f"windows, {syncs / max(1, windows):.2f} host syncs a "
          f"window; kernel 9 launches a decode step {dec[0] // SERVE_CHUNK} "
          f"({len(probe.calls['decode'])} dispatches of {SERVE_CHUNK} "
          f"steps), a prefill {cores(pre)} x {len(probe.calls['prefill'])},"
          f" a fused admission {cores(fus)} x {len(probe.calls['fused'])};"
          f" {run['launches']['int8_matmul']} in the run, no other kernel; "
          f"peak memory {run['peak_gib']:.2f} GiB; device idle share over "
          f"one decode window of {SERVE_CHUNK} steps {prof['idle_share']:.4f}"
          f" ({prof['launches']} launches, {prof['wall_s'] * 1e3:.1f} ms)"
          f"{ab}{drafts}; on {smi}")
    print(f"[{phase}] {label}: teacher-forced: {_tf_line(tf, sampling)}")
    return {**{k: v for k, v in run.items() if k != "launches"},
            "launches": run["launches"]["int8_matmul"],
            "decode_steps": steps, "windows": windows,
            "syncs_per_window": syncs / max(1, windows),
            "launches_per_decode_step": dec[0] // SERVE_CHUNK,
            "launches_per_prefill": None if pre is None else pre[0],
            "launches_per_admission": None if fus is None else fus[0],
            "idle_share_window": prof["idle_share"],
            "tokens_per_lane_step": lane_tokens,
            "ab_choice": eng.ab_choice,
            **{k: v for k, v in tf.items() if k not in ("ok", "label")}}


def _v1_workload(np, n_req):
    """bench.py's serve workload (seed 5) and its warm-up prompt maker."""
    rng = np.random.default_rng(5)
    reqs = []
    for _ in range(n_req):
        q_len = int(rng.integers(8, 64))
        budget = int(rng.integers(16, 128))
        img = rng.integers(50305, 58497, size=256)
        q = rng.integers(2, 50000, size=q_len)
        reqs.append((np.concatenate([[SERVE_MMU, SERVE_SOI], img,
                                     [SERVE_EOI], q]).astype(np.int64),
                     budget))

    def wreq(bucket):
        q = rng.integers(2, 50000, size=bucket - 261)
        img = rng.integers(50305, 58497, size=256)
        return np.concatenate([[SERVE_MMU, SERVE_SOI], img, [SERVE_EOI],
                               q]).astype(np.int64)

    return reqs, wreq


def _warm(server, submit_w, buckets):
    """bench.py's warm-up off the clock: a plain prefill per bucket from
    idle, then (with fused admission) an admission per bucket while a
    lane decodes, under a forced "alt" A/B; probation restarts after."""
    import torch

    eng = server.engine
    gen = torch.Generator(device=eng.device).manual_seed(0)
    for bucket in buckets:
        submit_w(bucket, 4)
        server.run(gen)
    if eng._fused_admit_for is not None:
        eng.force_ab("alt")
        submit_w(buckets[0], 8)
        for bucket in buckets:
            submit_w(bucket, 4)
        server.run(gen)
    eng.reset_ab()


def _serve_cap(spec):
    """bench.py:608: one window-chunk of steps of margin, (spec + 1) tokens
    each, and a step a slot for fused admissions."""
    return -(-(324 + 128 + SERVE_CHUNK * (spec + 1) + SERVE_SLOTS) // 64) * 64


@contextlib.contextmanager
def _planted_scatter_fault():
    """A copy of the chunk program whose side-buffer scatter writes lane
    0's K/V at its length + 1."""
    from showo_tpu_torch.serving import speculative as tspec

    real = tspec.scatter_fresh

    def faulty(cache_k, cache_v, fk, fv, lens0):
        lens0 = lens0.clone()
        lens0[0] += 1
        return real(cache_k, cache_v, fk, fv, lens0)

    tspec.scatter_fresh = faulty
    try:
        yield
    finally:
        tspec.scatter_fresh = real


def _no_sync_chunk(torch, phi):
    """One greedy plain decode chunk under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync in it
    raises.  Returns its wall ms."""
    from showo_tpu_torch.sampling.ar import sampler
    from showo_tpu_torch.serving.decode_chunk import (build_v1_decode_chunk,
                                                      kv_cache_zeros)
    from showo_tpu_torch.serving.engine import to_device
    import numpy as np

    cfg = phi.cfg
    cap = _serve_cap(0)
    emb = phi.model.embed_tokens.weight
    shape = (cfg.num_layers, SERVE_SLOTS, cap, cfg.num_heads, cfg.head_dim)
    ck = kv_cache_zeros(shape, False, emb.dtype, emb.device)
    cv = kv_cache_zeros(shape, False, emb.dtype, emb.device)
    dec = build_v1_decode_chunk(phi, cap=cap, chunk=SERVE_CHUNK,
                                slots=SERVE_SLOTS,
                                sample=sampler(1.0, 1, None))
    lengths = to_device(np.arange(SERVE_SLOTS, dtype=np.int32) * 37 + 5,
                        emb.device)
    tok = torch.arange(SERVE_SLOTS, device=emb.device) + 100
    dec(ck, cv, lengths, tok, None)                     # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = dec(ck, cv, lengths, tok, None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if int(out[0][0].item()) != 5 + SERVE_CHUNK:
        raise AssertionError("the chunk did not advance the lengths")
    return (time.perf_counter() - t0) * 1e3


def phase_serve_v1(torch, np, cuda_build, profile, inference_mmu, smi):
    """Phase 22: bench.py's three v1 serve rows through ShowoMMUServer on
    Show-o 1.3B at full width (``inference_mmu.build_pipeline`` with
    int8: fuse_parallel_mlp, then quantize_int8; random bf16 weights from
    the seed), the planted fault, and one greedy plain chunk without a host
    sync."""
    from showo_tpu_torch.config import load_config
    from showo_tpu_torch.models.phi import Int8Linear
    from showo_tpu_torch.serving import ShowoMMUServer

    pipe = inference_mmu.build_pipeline(
        load_config("configs/showo_demo.yaml", ["int8=1"]), "cuda")
    model, phi = pipe.model, pipe.model.showo
    lc = phi.cfg
    if not (lc.num_layers == NUM_LAYERS and lc.hidden_size == 2048
            and lc.vocab_size == 58498 and model.cfg.llm_vocab_size + 2
            == SERVE_EOI and all(isinstance(layer.win, Int8Linear)
                                 and isinstance(layer.wout, Int8Linear)
                                 for layer in phi.model.layers)
            and isinstance(phi.lm_head, Int8Linear)):
        raise AssertionError(f"[22] not the full-width fused int8 Phi: {lc}")
    eoi = SERVE_EOI
    ref_fn = _v1_reference(torch, phi, eoi)
    rows = {}
    with torch.no_grad():
        for label, (spec, n_req, sampling) in SERVE_V1_ROWS.items():
            reqs, wreq = _v1_workload(np, n_req)
            temperature, top_k, top_p = sampling or (1.0, 1, None)
            server = ShowoMMUServer(
                model, slots=SERVE_SLOTS, cap=_serve_cap(spec),
                chunk=SERVE_CHUNK, buckets=SERVE_BUCKETS,
                temperature=temperature, top_k=top_k, top_p=top_p,
                speculative_k=spec, lookahead=SERVE_LOOKAHEAD)
            t0 = time.perf_counter()
            _warm(server, lambda b, n: server.submit(wreq(b), n),
                  SERVE_BUCKETS)
            probe = _ServeProbe(cuda_build, server)
            submits = [lambda p=p, b=b: server.submit(p, b) for p, b in reqs]
            window = [lambda p=p: server.submit(p, 127)
                      for p, _ in reqs[:SERVE_SLOTS]]
            rows[label] = _serve_row(
                torch, cuda_build, profile, server, probe, label, 22,
                submits, [b for _, b in reqs], sampling, spec,
                SERVE_V1_MATMULS, ref_fn, window, smi)
            rows[label]["phase_s"] = time.perf_counter() - t0
            if label == "serve_v1_spec2_int8":
                rows[label]["fault"] = _serve_fault(
                    torch, model, reqs[:SERVE_FAULT_REQUESTS], spec,
                    ref_fn, cuda_build)
            server = probe = None
        sync_ms = _no_sync_chunk(torch, phi)
    print(f"[22] one greedy plain decode chunk ({SERVE_CHUNK} steps, "
          f"{SERVE_SLOTS} lanes) under torch.cuda.set_sync_debug_mode"
          f"('error'): no host sync, {sync_ms:.1f} ms")
    rows["no_sync_chunk_ms"] = sync_ms
    return rows


def _serve_fault(torch, model, reqs, spec, ref_fn, cuda_build):
    """The planted fault on the first requests of the spec-2 greedy row: it
    must fail the teacher-forced check."""
    from showo_tpu_torch.serving import ShowoMMUServer

    with _planted_scatter_fault():
        server = ShowoMMUServer(
            model, slots=SERVE_SLOTS, cap=_serve_cap(spec),
            chunk=SERVE_CHUNK, buckets=SERVE_BUCKETS, top_k=1,
            speculative_k=spec, lookahead=SERVE_LOOKAHEAD)
        probe = _ServeProbe(cuda_build, server)
        handles = [server.submit(p, b) for p, b in reqs]
        server.run(torch.Generator(device=server.engine.device).manual_seed(1))
    tf = _teacher_forced(torch, ref_fn, handles, probe.snaps, None, "fault")
    print(f"[22] planted fault (lane 0's decode K/V at its length + 1, "
          f"{len(reqs)} requests of serve_v1_spec2_int8): the teacher-forced"
          f" check {'passes: NOT caught' if tf['ok'] else 'fails'}: "
          f"{_tf_line(tf, None)}")
    if tf["ok"]:
        raise AssertionError("[22] the planted fault passes the "
                             "teacher-forced check")
    return {k: v for k, v in tf.items() if k not in ("ok", "label")}


def phase_serve_v2(torch, np, cuda_build, profile, inference_mmu_v2, smi):
    """Phase 22b: serve_v2_spec2_int8 through Showo2MMUServer on Show-o2
    1.5B at full width (``inference_mmu_v2.build_pipeline`` with int8):
    bench.py's 12 embedding prompts (latents from seeded draws through
    ``embed_images``, the time row, random text ids), 8 slots, buckets 768
    / 832, draft length 2, greedy."""
    from showo_tpu_torch.config import load_config
    from showo_tpu_torch.models.phi import Int8Linear
    from showo_tpu_torch.serving import Showo2MMUServer
    from showo_tpu_torch.show_o2.showo2 import _time_embeds, embed_images

    pipe = inference_mmu_v2.build_pipeline(load_config(V2_CONFIG, ["int8=1"]),
                                           "cuda")
    model, qwen = pipe.model, pipe.model.showo
    cfg = model.cfg
    if not (qwen.cfg.num_layers == V2_QWEN_LAYERS
            and qwen.cfg.hidden_size == 1536
            and cfg.num_image_tokens == 730
            and all(isinstance(m, Int8Linear) for m in _v2_matmuls(qwen))):
        raise AssertionError(f"[22b] not the full-width int8 Qwen2.5: "
                             f"{qwen.cfg}")
    dev = pipe.device
    embed = qwen.model.embed_tokens
    spec = SERVE_V2_SPEC
    rng = np.random.default_rng(7)
    reqs = []
    with torch.no_grad():
        _, te = _time_embeds(model, torch.ones((1,), device=dev))
        for i in range(SERVE_V2_REQUESTS):
            q_len = int(rng.integers(8, 40))
            budget = int(rng.integers(16, 128))
            g = torch.Generator(device=dev).manual_seed(10 + i)
            latents = torch.randn((1, cfg.image_latent_dim,
                                   cfg.image_latent_height,
                                   cfg.image_latent_width), generator=g,
                                  device=dev).to(embed.weight.dtype)
            pre = rng.integers(10, 150000, size=24)
            post = rng.integers(10, 150000, size=q_len)
            emb = torch.cat([embed(torch.as_tensor(pre, device=dev)),
                             te.to(embed.weight.dtype),
                             embed_images(model, latents)[0],
                             embed(torch.as_tensor(post, device=dev))])
            reqs.append((emb, budget, post))
        cap = SERVE_V2_BUCKETS[-1] + 128 + SERVE_CHUNK * (spec + 1)
        server = Showo2MMUServer(
            model, slots=SERVE_SLOTS, cap=cap, chunk=SERVE_CHUNK,
            buckets=SERVE_V2_BUCKETS, top_k=1, speculative_k=spec,
            lookahead=SERVE_LOOKAHEAD)
        t0 = time.perf_counter()
        D = qwen.cfg.hidden_size

        def submit_w(bucket, budget):
            return server.submit(torch.zeros((bucket - 8, D), device=dev,
                                             dtype=embed.weight.dtype),
                                 SERVE_V2_IMG_START, budget,
                                 lookup_ids=np.zeros(4, np.int64))

        _warm(server, submit_w, SERVE_V2_BUCKETS)
        probe = _ServeProbe(cuda_build, server)
        submits = [lambda e=e, b=b, ids=ids: server.submit(
            e, SERVE_V2_IMG_START, b, lookup_ids=ids) for e, b, ids in reqs]
        window = [lambda e=e, ids=ids: server.submit(
            e, SERVE_V2_IMG_START, 127, lookup_ids=ids)
            for e, _, ids in reqs[:SERVE_SLOTS]]
        row = _serve_row(torch, cuda_build, profile, server, probe,
                         "serve_v2_spec2_int8", "22b", submits,
                         [b for _, b, _ in reqs], None, spec,
                         SERVE_V2_MATMULS,
                         _v2_reference(torch, qwen, cfg.num_image_tokens),
                         window, smi)
        row["phase_s"] = time.perf_counter() - t0
    return row


def _v2_train_meta(torch, seq_len, batch_size=2):
    """The trainable route's metadata of a seeded Show-o2 stage-1 batch of
    ``seq_len`` tokens (``profile_train.v2_batch``): seg from the modality
    positions, no pads."""
    from showo_tpu_torch.ops.flash_attention import (
        seg_from_modality_positions, span_meta)
    from showo_tpu_torch.profile_train import v2_batch
    from showo_tpu_torch.show_o2.showo2 import Showo2Config

    batch = v2_batch(Showo2Config().num_image_tokens, batch_size, seq_len)
    mp = torch.as_tensor(batch["modality_positions"], device="cuda")
    seg = seg_from_modality_positions(mp, seq_len)
    return span_meta(seg, None, None, None, batch_size, seq_len, seg.device)


def phase_v2_train_kernels(torch, phase="23"):
    """Kernels 7 and 8 at head dim 128 (Qwen2.5's 12 q / 2 kv heads) on the
    metadata of the Show-o2 stage-1 batch, B=2: kernel 7 at S=1024 and
    kernel 8 at S=2048.  Each kernel set's tile map against its plain
    version byte for byte; the forward, lse, dq and dk/dv against the
    plain versions (CARD_TOL, GRAD_TOL) and bit-stable over two launches;
    CUDA-event medians of kernel, plain version and the library
    (``scaled_dot_product_attention`` under the same mask, GQA), device
    times from the profiler, the bounds; then the planted faults (V of the
    wrong kv head; one 64-key tile dropped from the plain version's mask),
    each of which must fail the check.  Returns {counter: result}."""
    import torch.nn.functional as F

    from showo_tpu_torch.ops import streaming_attention_grad as tsag

    h, hkv, d = V2_TRAIN_HEADS
    g = torch.Generator(device="cuda").manual_seed(23)
    results = {}
    for kernel, S in ((7, V2_TRAIN_SEQ[0]), (8, V2_TRAIN_SEQ[1])):
        m = _v2_train_meta(torch, S)
        ks = _kernel_set(torch, kernel, hkv, H=h, D=d)
        B = m[0].shape[0]
        vis = tsag.self_visible(*m)
        n_vis = int(vis.sum())
        shape = (f"kernel {kernel}, Show-o2 stage-1 batch: B={B} S={S} "
                 f"H={h} Hkv={hkv} D={d}")
        q, k, v, dout = (ks["tensor"](g, B, S, n) for n in (h, hkv, hkv, h))
        tiles, tiles_result = _tile_map_check(torch, ks, m, shape, phase)
        bwd = {"tiles": tiles}
        out, lse = ks["fwd"](q, k, v, *m, **bwd)
        lse_err = (lse - ks["fwd_plain"](q, k, v, *m)[1]).abs().max().item()
        if not lse_err <= CARD_TOL:
            raise AssertionError(f"{shape}: lse err {lse_err}")
        delta = ks["delta"](out, dout)
        args = (q, k, v, dout, lse, delta, *m)
        _bit_stable(torch, ks, args, tiles, shape, phase)
        tensor = 2 * B * S * d
        meta_bytes = 4 * (2 * B * S + 2 * B)
        rows_bytes = 4 * B * h * S
        bounds = {
            "fwd": _bound((2 * h + 2 * hkv) * tensor + rows_bytes
                          + meta_bytes, 4 * d * h * n_vis),
            "dq": _bound((3 * h + 2 * hkv) * tensor + 2 * rows_bytes
                         + meta_bytes, 6 * d * h * n_vis),
            "dkv": _bound((2 * h + 4 * hkv) * tensor + 2 * rows_bytes
                          + meta_bytes, 8 * d * h * n_vis)}
        heads = [ks["heads"](t).detach().requires_grad_(True)
                 for t in (q, k, v)]
        mask = vis[:, None]
        o4 = F.scaled_dot_product_attention(*heads, attn_mask=mask,
                                            enable_gqa=True)
        lib = {"fwd": lambda: F.scaled_dot_product_attention(
                   *heads, attn_mask=mask, enable_gqa=True),
               "bwd": lambda: torch.autograd.grad(o4, heads, ks["heads"](
                   dout), retain_graph=True)}
        calls = {"fwd": lambda: ks["fwd"](q, k, v, *m, **bwd)[0],
                 "dq": lambda: ks["dq"](*args, **bwd),
                 "dkv": lambda: ks["dkv"](*args, **bwd)}
        plains = {"fwd": lambda: ks["fwd_plain"](q, k, v, *m)[0],
                  "dq": lambda: ks["dq_plain"](*args),
                  "dkv": lambda: ks["dkv_plain"](*args)}
        for name, part in zip(ks["counters"], ("fwd", "dq", "dkv")):
            what = {"fwd": "forward", "dq": "dq", "dkv": "dk/dv"}[part]
            r = _compare(torch, f"trainable {what} {shape}", calls[part],
                         plains[part], bounds[part],
                         lib["fwd" if part == "fwd" else "bwd"],
                         phase=phase, grads=part != "fwd")
            r["device_ms"] = _device_ms(torch, calls[part])
            print(f"[{phase}] {shape}: {what} device {_ms(r['device_ms'])} "
                  f"a launch (profiler, mean of 20), "
                  f"{_ratio(r['device_ms'], r['bound_ms'])} its bound")
            results[name + D128] = r
        results[ks["tiles"][0] + f"_v2_s{S}"] = tiles_result
        heads = o4 = lib = None
        print(f"[{phase}] {shape}: lse max_abs_err {lse_err:.3e}; "
              f"{n_vis} visible (row, key) pairs of {B * S * S} "
              f"({n_vis / (B * S * S):.4f}); library of dq and dk/dv: one "
              f"backward of scaled_dot_product_attention")
        _planted_faults(shape, {
            "forward": (lambda v_, m_: ks["fwd_plain"](q, k, v_, *m_)[0],
                        False),
            "dq": (lambda v_, m_: ks["dq_plain"](q, k, v_, *args[3:6], *m_),
                   True),
            "dk/dv": (lambda v_, m_: ks["dkv_plain"](q, k, v_, *args[3:6],
                                                     *m_), True),
        }, v, ks["wrong_v"](v), m, phase)
    return results


def _v2_train_want(steps: int, seq_len: int) -> dict:
    """The launch counts of ``steps`` Show-o2 stage-1 steps on the
    trainable route (remat "full": two forwards a layer): 28 Qwen2.5
    layers at head dim 128 and 10 DiT layers at 64, on kernel 7 at 1024
    tokens and on kernel 8 at 2048; each forward makes one tile map."""
    table = TRAIN_KERNELS if seq_len <= 1024 else STREAM_TRAIN_KERNELS
    fwd, dq, dkv, tiles = list(table)
    layers = V2_QWEN_LAYERS + V2_DIT_LAYERS
    want = {name: 0 for name in COUNTERS}
    want.update({fwd: 2 * layers * steps, dq: layers * steps,
                 dkv: layers * steps, tiles: 2 * layers * steps,
                 fwd + D128: 2 * V2_QWEN_LAYERS * steps,
                 dq + D128: V2_QWEN_LAYERS * steps,
                 dkv + D128: V2_QWEN_LAYERS * steps})
    return want


def _v2_trainer(torch, phase):
    """The full-width Show-o2 stage-1 trainer through the CLI's
    ``build_trainer`` (trainable, remat full, AdamW), checked to be at
    full width."""
    from showo_tpu_torch.profile_train import v2_config
    from showo_tpu_torch.show_o2.train_stage_one import build_trainer

    t0 = time.perf_counter()
    trainer = build_trainer(v2_config(), torch.device("cuda"),
                            attn_impl="trainable")
    c = trainer.model.cfg
    if not (c.llm.num_layers == V2_QWEN_LAYERS and c.llm.hidden_size == 1536
            and (c.llm.num_heads, c.llm.num_kv_heads, c.llm.head_dim)
            == V2_TRAIN_HEADS and c.dit.num_layers == V2_DIT_LAYERS
            and c.dit.hidden_size == 2048 and c.dit.head_dim == 64
            and trainer.sc.remat == "full"
            and trainer.sc.attn_impl == "trainable"):
        raise AssertionError(f"not the full-width stage-1 trainer: {c}")
    n_train = sum(p.numel() for p in trainer.optimizer.params)
    n_all = sum(p.numel() for p in trainer.model.parameters())
    print(f"[{phase}] Show-o2 stage-1 trainer built from {V2_TRAIN_CONFIG} "
          f"(warmup 0) in {time.perf_counter() - t0:.1f} s: {n_all} "
          f"parameters, {n_train} trainable (frozen: "
          f"{', '.join(trainer.frozen_substrings)}), AdamW, clip "
          f"{trainer.sc.max_grad_norm}, remat {trainer.sc.remat}")
    return trainer


def _v2_steps(torch, cuda_build, trainer, batch, steps, seq_len, label,
              phase):
    """``steps`` steps on ``batch`` with one fixed draw each (so the loss
    falls), the launch counts set to 0 before them and held to
    :func:`_v2_train_want`; returns (walls, losses, metrics, counts)."""
    cuda_build.launches.clear()
    walls, losses, metrics = [], [], []
    for _ in range(steps):
        gen = torch.Generator(device="cuda").manual_seed(24)
        t0 = time.perf_counter()
        m = trainer.train_step(batch, gen)
        losses.append(float(m["loss"]))             # waits for the step
        walls.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    want = _v2_train_want(steps, seq_len)
    counts = {name: cuda_build.launches[name] for name in want}
    if counts != want:
        raise AssertionError(f"{label}: launches over {steps} steps "
                             f"{counts}, want {want}")
    if not all(x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"{label}: losses not finite: {losses}")
    return walls, losses, metrics, counts


def phase_v2_train(torch, cuda_build, profile, trainer, smi, phase="24"):
    """The Show-o2 stage-1 trainer at full width on ``trainable``: a warm
    step, then V2_TRAIN_STEPS steps of one seeded batch of V2_TRAIN_BATCH
    rows x 1024 tokens (V2_TRAIN_UND of them und) with one fixed draw (launch counts
    per step: kernel 7 76 forwards / 38 dq / 38 dk+dv, of them 56 / 28 /
    28 at head dim 128, 76 tile maps; losses falling), s per step,
    samples/s, peak memory; the idle share and kernel launches of one
    profiled step; then one step of a 2-row batch of 2048 tokens (kernel 8
    in both towers).  Returns {"slice": ..., "counts": {S: counts}}."""
    from showo_tpu_torch.profile_train import v2_batch

    n_img = trainer.model.cfg.num_image_tokens
    batch = v2_batch(n_img, V2_TRAIN_BATCH, V2_TRAIN_SEQ[0],
                     und=V2_TRAIN_UND)
    gen = torch.Generator(device="cuda").manual_seed(24)
    trainer.train_step(batch, gen)                        # warm step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, losses, metrics, counts = _v2_steps(
        torch, cuda_build, trainer, batch, V2_TRAIN_STEPS, V2_TRAIN_SEQ[0],
        "stage-1 batch", phase)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"losses not falling on one batch: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    wall = statistics.median(walls)
    last = metrics[-1]
    prof = profile(lambda: trainer.train_step(
        batch, torch.Generator(device="cuda").manual_seed(24)),
        f"[{phase}] profiled step")
    print(f"[{phase}] Show-o2 stage-1 training, route trainable, "
          f"{V2_TRAIN_BATCH} rows ({V2_TRAIN_BATCH - V2_TRAIN_UND} t2i, "
          f"{V2_TRAIN_UND} und) x {V2_TRAIN_SEQ[0]} tokens "
          f"at 432x432, bf16 autocast, remat {trainer.sc.remat}, "
          f"{trainer.sc.optimizer}: launches per step "
          f"{_per_step(counts, V2_TRAIN_STEPS)}, 0 of the other kernels; "
          f"losses {[round(x, 4) for x in losses]}; last step ntp "
          f"{last['loss_ntp']:.4f} flow {last['loss_flow']:.4f} grad_norm "
          f"{last['grad_norm']:.4f}; step {wall:.4f} s (median of "
          f"{V2_TRAIN_STEPS}: {', '.join(f'{w:.4f}' for w in walls)}), "
          f"{V2_TRAIN_BATCH / wall:.3f} samples/s, peak memory allocated "
          f"{peak:.2f} GiB; profiled step: idle share "
          f"{prof['idle_share']:.4f}, {prof['launches']} device launches, "
          f"busy {prof['busy_ms']:.1f} ms on {smi}")
    long_batch = v2_batch(n_img, 2, V2_TRAIN_SEQ[1])
    torch.cuda.reset_peak_memory_stats()
    lwalls, llosses, _, lcounts = _v2_steps(
        torch, cuda_build, trainer, long_batch, 1, V2_TRAIN_SEQ[1],
        "the 2048-token batch", phase)
    lpeak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[{phase}] one step of 2 rows x {V2_TRAIN_SEQ[1]} tokens (both "
          f"towers past the packed budget: kernel 8): launches "
          f"{_per_step(lcounts, 1)}; loss {llosses[0]:.4f}; "
          f"{lwalls[0]:.4f} s; peak memory allocated {lpeak:.2f} GiB")
    return {"slice": {"step_s": wall, "samples_per_s": V2_TRAIN_BATCH / wall,
                      "peak_gib": peak, "idle_share": prof["idle_share"],
                      "launches_profiled": prof["launches"],
                      "losses": losses, "step_s_2048": lwalls[0],
                      "peak_gib_2048": lpeak},
            "counts": {V2_TRAIN_SEQ[0]: counts, V2_TRAIN_SEQ[1]: lcounts}}


def phase_v2_train_parity(torch, trainer, phase="25"):
    """One full-width Show-o2 stage-1 step's losses and grad norm on
    ``trainable`` and on ``dense``: the same weights, batch and draws (one
    prepared batch, its attention inputs swapped)."""
    from showo_tpu_torch.profile_train import v2_batch
    from showo_tpu_torch.show_o2.masks import omni_attn_mask
    from showo_tpu_torch.training.train_step import global_norm

    step = trainer.step_fn
    batch = trainer.device_batch(v2_batch(trainer.model.cfg.num_image_tokens,
                                          2, V2_TRAIN_SEQ[0], und=1))
    prepared = step.prepare(batch, torch.Generator(device="cuda")
                            .manual_seed(25))
    L = prepared.text_tokens.shape[1]
    dense = dataclasses.replace(prepared, attn_meta=None, bias=omni_attn_mask(
        prepared.modality_positions, L))
    got = {}
    for route, b in (("trainable", prepared), ("dense", dense)):
        total, parts, grads = step.loss_and_grads(b)
        got[route] = [float(x) for x in (total, *parts, global_norm(grads))]
        del grads
    names = ("loss", "loss_ntp", "loss_flow", "grad_norm")
    rel = {n: abs(a - b) / abs(b) for n, a, b in
           zip(names, got["trainable"], got["dense"])}
    print(f"[{phase}] Show-o2 training step parity, trainable vs dense (28 "
          f"+ 10 layers, 2 rows x {L}, one und row, bf16 autocast): "
          + ", ".join(f"{n} {a:.5f} vs {b:.5f} (rel {rel[n]:.2e})"
                      for n, a, b in zip(names, got["trainable"],
                                         got["dense"]))
          + f"; tol {V2_TRAIN_LOSS_TOL} (losses), {V2_TRAIN_GRAD_NORM_TOL} "
          f"(grad norm)")
    bad = [n for n in names if rel[n] > (V2_TRAIN_GRAD_NORM_TOL
                                         if n == "grad_norm"
                                         else V2_TRAIN_LOSS_TOL)]
    if bad:
        raise AssertionError(f"trainable vs dense differ in {bad}: {rel}")
    return {"rel": rel}


def phase_v2_cli(torch, cuda_build, phase="26"):
    """The stage-1 CLI itself, in process
    (``train_stage_one.main(argv)``), at full width and a reduced depth
    (2 Qwen2.5, 2 DiT, 2 SigLIP layers; phase 24 has the depth): a jsonl
    in a temporary directory of two records pointing at the in-tree
    image, 1 t2i + 1 und row a step, ``save_every`` 1: two steps, then a
    second run resuming from ``latest`` at step 2 to step 3 (its loader
    state restored), each step's kernel launches counted."""
    import tempfile

    from showo_tpu_torch.show_o2 import train_stage_one

    image = os.path.abspath(MMU_IMAGE)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data.jsonl")
        with open(data, "w") as f:
            for i, prompt in enumerate(("a photo of a cat", "a red car")):
                f.write(json.dumps({"path": image, "prompt": prompt}) + "\n")
        out = os.path.join(tmp, "out")
        argv = [f"config={V2_TRAIN_CONFIG}", "training.warmup_steps=0",
                "training.attn_impl=trainable", "training.batch_size_t2i=1",
                "training.batch_size_mmu=1", "model.showo.llm_num_layers=2",
                "model.showo.num_diffusion_layers=2",
                "model.showo.siglip={num_layers: 2}",
                f"dataset.params.t2i_jsonl={data}",
                f"dataset.params.mmu_jsonl={data}",
                f"experiment.output_dir={out}", "experiment.save_every=1",
                "experiment.log_every=1", "experiment.generate_every=null",
                "experiment.checkpoints_total_limit=2"]
        t0 = time.perf_counter()
        cuda_build.launches.clear()
        first = train_stage_one.main(argv + ["training.max_train_steps=2"])
        mid = time.perf_counter()
        counts = {n: c for n, c in cuda_build.launches.items() if c}
        saved = sorted(d for d in os.listdir(out)
                       if d.startswith("checkpoint-"))
        resumed = train_stage_one.main(argv + ["training.max_train_steps=3"])
        end = time.perf_counter()
        if not (first.global_step == 2 and saved == ["checkpoint-1",
                                                     "checkpoint-2"]
                and resumed.global_step == 3
                and resumed.optimizer.steps == 3):
            raise AssertionError(f"CLI run: steps {first.global_step} / "
                                 f"{resumed.global_step}, checkpoints "
                                 f"{saved}")
        want = {n + D128: 2 * 2 * 2 for n in list(TRAIN_KERNELS)[:1]}
        if any(counts.get(n, 0) != c for n, c in want.items()):
            raise AssertionError(f"CLI launches {counts}, want {want}")
        print(f"[{phase}] the stage-1 CLI at full width, depth 2 / 2 / 2: "
              f"2 steps and checkpoints {saved} in {mid - t0:.1f} s, "
              f"resumed from latest (step 2, the loader state restored) to "
              f"step 3 in {end - mid:.1f} s; launches of the first run "
              f"{counts}")
        first = resumed = None
    return {"first_s": mid - t0, "resume_s": end - mid}


def phase_fused_bf16(torch, np, inference_t2i, cuda_build, smi,
                     phase="27"):
    """Kernel 2's bf16-score variant (``attn_fp32=False``).  At the 512^2
    cached step (phase 3's shape and layout, its own seeded tensors): the
    whole and the core against their plain versions in bf16 softmax
    (CARD_TOL), the core beside the fp32 variant on the same memory
    (event and device ms), ``scaled_dot_product_attention`` on the
    core's part, and a planted fault (the split off by one row: key and
    value row P read from the cache) that the check must catch.  Then the
    512x512 ``fused`` pipeline through ``build_pipeline`` with
    ``model.showo.attn_fp32=False`` beside the fp32 one (the same seeded
    weights): one warm generate each, the bf16 generate's launches (384
    cores, all bf16, 384 passes, 16 maps), s a generate in turns (fp32,
    bf16, bf16, fp32) and the token agreement of the two on the same
    draws.  Returns {"kernel": result, "slice": ...}."""
    import torch.nn.functional as F

    from showo_tpu_torch.config import load_config
    from showo_tpu_torch.models.phi import rope_tables
    from showo_tpu_torch.ops import flash_attention as tfa
    from showo_tpu_torch.ops import fused_decode as tfd

    device, bf = torch.device("cuda"), torch.bfloat16
    configs = {fp32: load_config("configs/showo_demo_512x512.yaml", [
        "guidance_scale=1.75", f"generation_timesteps={TIMESTEPS}",
        f"model.showo.attn_fp32={fp32}"]) for fp32 in (True, False)}
    config = configs[False]
    cfg = inference_t2i.build_showo_config(config)
    if cfg.llm.attn_fp32:
        raise AssertionError("model.showo.attn_fp32=False did not reach "
                             "the model's config")
    uni = inference_t2i.build_prompting(config)
    prompts = inference_t2i.load_prompts(config)[:BATCH]
    sp = uni.sptids
    hidden = H * D
    full = _t2i_layout(uni, prompts, 1024, cfg.mask_token_id, device)
    B, L = full.shape
    Q = L - P
    meta = tfa.metadata_predict_next(full, sp["<|pad|>"], sp["<|soi|>"],
                                     sp["<|eoi|>"])
    pos = torch.arange(P, L, device=device)
    rows = tfd.fused_rows(meta[0], meta[1], pos, P, B)
    shape = f"B={B} Q={Q} K={L} H={H} D={D}"
    g = torch.Generator(device=device).manual_seed(27)

    def randn(*s):
        return torch.randn(*s, generator=g, device=device).bfloat16()

    y = randn(B, Q, 3 * hidden + cfg.llm.intermediate_size)
    cache = randn(2, B, L, H, D)
    ln = [(1 + 0.1 * torch.randn(D, generator=g, device=device)).bfloat16(),
          (0.1 * torch.randn(D, generator=g, device=device)).bfloat16()]
    cos, sin = rope_tables(pos, 32, cfg.llm.rope_theta)
    ck, cv = cache[0, :, :P].flatten(2), cache[1, :, :P].flatten(2)
    args = (y, ck, cv, ln, ln, cos, sin)
    kw = dict(hidden=hidden, num_heads=H, rotary_dim=32, eps=1e-5)
    part = dict(hidden=hidden, num_heads=H)
    tiles = tfd.fused_tile_map(rows, meta[2], meta[3])
    vis = tfa.visible_mask(rows[3], rows[4], meta[2], meta[3], rows[0],
                           pos_k=rows[2], seg_q=rows[1])
    flops = 4 * D * H * int(vis.sum())
    meta_bytes = 4 * (2 * B * L + 2 * B + 2 * B * Q)
    io = 2 * B * Q * hidden
    whole = _compare(
        torch, f"fused_decode_attention bf16 scores {shape}, both launches",
        lambda: tfd.fused_decode_attention(*args, *meta, pos, rows=rows,
                                           tiles=tiles, softmax_dtype=bf,
                                           **kw),
        lambda: tfd.fused_decode_attention_plain(
            *args, meta[2], meta[3], rows, sm_scale=D ** -0.5,
            softmax_dtype=bf, **kw),
        _bound(4 * io + 2 * 2 * B * P * hidden + 2 * Q * 32 * 4 + 8 * D
               + meta_bytes, flops), phase=phase)
    qn, kn = tfd.norm_rope(y, ln, ln, cos, sin, **kw)

    def core(dtype):
        return lambda: tfd.fused_attend(qn, kn, y, ck, cv, meta[2], meta[3],
                                        rows, tiles, softmax_dtype=dtype,
                                        **part)

    def core_plain(qn_, kn_, y_, ck_, cv_):
        return tfd.fused_attend_plain(qn_, kn_, y_, ck_, cv_, meta[2],
                                      meta[3], rows, sm_scale=D ** -0.5,
                                      softmax_dtype=bf, **part)

    keys = [torch.cat([ck, kn], 1),
            torch.cat([cv, y[..., 2 * hidden:3 * hidden]], 1)]
    heads = [t.unflatten(-1, (H, D)).transpose(1, 2) for t in [qn] + keys]
    before = cuda_build.launches[FUSED_BF16]
    r = _compare(
        torch, f"fused_decode core bf16 scores {shape} (keys at pos_k, "
        f"split at P={P})", core(bf), lambda: core_plain(qn, kn, y, ck, cv),
        _bound(3 * io + 2 * 2 * B * P * hidden + meta_bytes + 4 * L, flops),
        lambda: F.scaled_dot_product_attention(*heads,
                                               attn_mask=vis[:, None]),
        phase=phase)
    if cuda_build.launches[FUSED_BF16] == before:
        raise AssertionError("the bf16 core did not launch the bf16 variant")
    r["whole"] = whole
    r["fp32_ms"] = _time_ms(torch, core(torch.float32))
    r["device_ms"] = _device_ms(torch, core(bf))
    r["fp32_device_ms"] = _device_ms(torch, core(torch.float32))
    diff = (core(bf)().float() - core(torch.float32)().float()).abs().max()
    r["fp32_diff"] = diff.item()
    # the planted fault: key and value row P from the cache's row P
    ck1, cv1 = (t.as_strided((B, P + 1, hidden), t.stride())
                for t in (ck, cv))
    bad = core_plain(qn, kn[:, 1:], y[:, 1:], ck1, cv1)
    fault = (bad.float() - core(bf)().float()).abs().max().item()
    if not fault > CARD_TOL:
        raise AssertionError(f"the planted fault passes the check: "
                             f"{fault} <= {CARD_TOL}")
    r["fault_err"] = fault
    print(f"[{phase}] {shape}: the bf16-score core {r['ms']:.4f} ms beside "
          f"the fp32 core on the same memory {r['fp32_ms']:.4f} ms (median "
          f"of 20); device {_ms(r['device_ms'])} / "
          f"{_ms(r['fp32_device_ms'])} a launch (profiler); bf16 against "
          f"fp32 max |difference| {r['fp32_diff']:.3e}; the planted fault "
          f"(split off by one row) {fault:.3e} > {CARD_TOL:.0e}: caught")

    # the slice: the fused pipelines, fp32 and bf16 softmax
    pipes = {}
    for fp32 in (True, False):
        t0 = time.perf_counter()
        pipes[fp32] = inference_t2i.build_pipeline(configs[fp32], device,
                                                   attn_impl="fused")
        layer = pipes[fp32].model.showo.model.layers[0]
        if not (pipes[fp32].attn_route == "fused"
                and layer.cfg.attn_fp32 == fp32
                and layer.cfg.num_layers == NUM_LAYERS):
            raise AssertionError(f"not the full-width fused pipeline with "
                                 f"attn_fp32={fp32}")
        print(f"[{phase}] fused pipeline attn_fp32={fp32} built in "
              f"{time.perf_counter() - t0:.1f} s")

    def gen():
        return torch.Generator(device=device).manual_seed(0)

    for p in pipes.values():
        p.generate(prompts, gen())                            # warm-up
    want = dict(_route_want("fused"), **{FUSED_BF16: NUM_LAYERS * TIMESTEPS})
    cuda_build.launches.clear()
    images = pipes[False].generate(prompts, gen())
    counts = {name: cuda_build.launches[name] for name in want}
    if counts != want:
        raise AssertionError(f"bf16 fused generate: launches {counts}, "
                             f"want {want}")
    _check_images(np, images, (BATCH, 512, 512, 3), "bf16 fused generate")
    walls = {True: [], False: []}
    for fp32 in (True, False, False, True):
        t0 = time.perf_counter()
        pipes[fp32].generate(prompts, gen())
        walls[fp32].append(time.perf_counter() - t0)
    codes = {fp32: p.generate_codes(prompts, gen())
             for fp32, p in pipes.items()}
    agree = (codes[True] == codes[False]).float().mean().item()
    s = {fp32: statistics.median(w) for fp32, w in walls.items()}
    print(f"[{phase}] slice t2i 512x512 route fused, attn_fp32=False, "
          f"{TIMESTEPS} steps, CFG 1.75, batch {BATCH}: launches per "
          f"generate {counts['fused_decode']} cores, all bf16 "
          f"({counts[FUSED_BF16]}), {counts[FUSED_NORM]} LN + RoPE passes, "
          f"{counts['fused_decode_tiles']} tile maps, 0 of the others; "
          f"images finite in [-1, 1]; warm wall {s[False]:.4f} s a generate "
          f"beside the fp32 softmax's {s[True]:.4f} s (in turns fp32, bf16, "
          f"bf16, fp32: {', '.join(f'{w:.4f}' for w in walls[False])} / "
          f"{', '.join(f'{w:.4f}' for w in walls[True])}), "
          f"{BATCH * 60.0 / s[False]:.2f} images/min; tokens equal to the "
          f"fp32 generate's on the same draws: {agree:.4f} on {smi}")
    pipes = None
    return {"kernel": r, "launches": counts[FUSED_BF16],
            "slice": {"s": s[False], "fp32_s": s[True], "walls": walls[False],
                      "fp32_walls": walls[True], "agreement": agree,
                      "counts": {n: c for n, c in counts.items() if c}}}


def _v2_mode(torch, trainer, remat: str, optimizer: str):
    """The trainer's step under the remat policy ``remat`` and the
    optimizer ``optimizer`` (built afresh, as ``make_stage1_optimizer``
    builds it, when it changes)."""
    from showo_tpu_torch.show_o2.train_stage_one import Stage1Step

    sc = dataclasses.replace(trainer.sc, remat=remat, optimizer=optimizer)
    if optimizer != trainer.sc.optimizer:
        trainer.optimizer = trainer.step_fn.optimizer = None
        gc.collect()
        torch.cuda.empty_cache()
        trainer.sc = sc
        trainer.optimizer = trainer.make_optimizer()
    trainer.sc = sc
    trainer.step_fn = Stage1Step(trainer.model, trainer.vae, sc,
                                 trainer.transport, trainer.optimizer,
                                 trainer.step_fn.autocast_dtype)


def _rung_steps(torch, cuda_build, trainer, batch, steps):
    """A warm step, then ``steps`` timed ones: (s a step, peak GiB,
    kernel 7's launches a step), or None where the card ran out of
    memory."""
    oom = False
    try:
        gen = torch.Generator(device="cuda").manual_seed(28)
        float(trainer.train_step(batch, gen)["loss"])
        torch.cuda.reset_peak_memory_stats()
        cuda_build.launches.clear()
        walls = []
        for _ in range(steps):
            t0 = time.perf_counter()
            float(trainer.train_step(batch, gen)["loss"])
            walls.append(time.perf_counter() - t0)
    except torch.cuda.OutOfMemoryError:
        oom = True
    gc.collect()                      # the error's frames are gone here
    torch.cuda.empty_cache()
    if oom:
        return None
    launches = {n: cuda_build.launches[n] / steps
                for n in list(TRAIN_KERNELS)[:3]}
    return {"s": statistics.median(walls), "walls": walls,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches}


def phase_rungs(torch, cuda_build, trainer, smi, phase="28"):
    """The remat rungs on phase 24's trainer (the full-width Show-o2
    stage-1 trainer on ``trainable``).  First, on one prepared batch (2
    rows x 1024, one und), each rung's losses and grad norm against
    ``full``'s within phase 25's limits.  Then the ladder at phase 24's
    shape (V2_TRAIN_BATCH rows x 1024): every rung of RUNGS under AdamW
    and under adafactor, a warm step and RUNG_STEPS timed ones: s a step,
    peak memory, kernel 7's launches a step (76 forwards: the forward is
    recomputed under every rung), or "out of memory" (a reading, not a
    failure; any other exception fails the phase); and one step of
    RUNG_BIG_BATCH rows under adafactor + ``qkv_fc1_attn``.  Returns
    {"parity": ..., "ladder": ..., "big": ...}."""
    from showo_tpu_torch.profile_train import v2_batch
    from showo_tpu_torch.training.train_step import global_norm

    n_img = trainer.model.cfg.num_image_tokens
    prepared = trainer.step_fn.prepare(trainer.device_batch(v2_batch(
        n_img, 2, V2_TRAIN_SEQ[0], und=1)), torch.Generator(
            device="cuda").manual_seed(28))
    got = {}
    for rung in ("full", "none") + RUNGS[1:]:
        trainer.step_fn.sc = dataclasses.replace(trainer.sc, remat=rung)
        total, parts, grads = trainer.step_fn.loss_and_grads(prepared)
        got[rung] = [float(x) for x in (total, *parts, global_norm(grads))]
        grads = None
    trainer.step_fn.sc = trainer.sc
    prepared = None
    names = ("loss", "loss_ntp", "loss_flow", "grad_norm")
    rel = {r: {n: abs(a - b) / abs(b)
               for n, a, b in zip(names, got[r], got["full"])} for r in got}
    bad = [r for r in rel if any(
        e > (V2_TRAIN_GRAD_NORM_TOL if n == "grad_norm"
             else V2_TRAIN_LOSS_TOL) for n, e in rel[r].items())]
    print(f"[{phase}] rung parity, one step on one prepared batch (2 rows x "
          f"{V2_TRAIN_SEQ[0]}, one und; trainable, bf16 autocast), loss, "
          f"ntp, flow, grad norm: "
          + "; ".join(f"{r} " + ", ".join(f"{v:.6f}" for v in got[r])
                      + f" (largest relative difference to full's "
                      f"{max(rel[r].values()):.2e})" for r in got)
          + f"; tol {V2_TRAIN_LOSS_TOL} (losses), {V2_TRAIN_GRAD_NORM_TOL} "
          f"(grad norm)")
    if bad:
        raise AssertionError(f"rungs {bad} differ from full: {rel}")
    batch = v2_batch(n_img, V2_TRAIN_BATCH, V2_TRAIN_SEQ[0],
                     und=V2_TRAIN_UND)
    ladder = {}
    for optimizer in RUNG_OPTIMIZERS:
        for rung in RUNGS:
            _v2_mode(torch, trainer, rung, optimizer)
            res = _rung_steps(torch, cuda_build, trainer, batch, RUNG_STEPS)
            ladder[f"{optimizer} {rung}"] = res or "out of memory"
            what = ("out of memory" if res is None else
                    f"{res['s']:.4f} s a step "
                    f"({', '.join(f'{w:.4f}' for w in res['walls'])}), "
                    f"{V2_TRAIN_BATCH / res['s']:.3f} samples/s, peak "
                    f"{res['peak_gib']:.2f} GiB, kernel 7 a step "
                    f"{res['launches']}")
            what += (f"; {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
                     f"held after it")
            print(f"[{phase}] ladder {V2_TRAIN_BATCH} rows x "
                  f"{V2_TRAIN_SEQ[0]}, trainable, {optimizer}, remat "
                  f"{rung}: {what}")
    _v2_mode(torch, trainer, "qkv_fc1_attn", "adafactor")
    big = _rung_steps(torch, cuda_build, trainer, v2_batch(
        n_img, RUNG_BIG_BATCH, V2_TRAIN_SEQ[0], und=V2_TRAIN_UND), 1)
    print(f"[{phase}] one step of {RUNG_BIG_BATCH} rows x {V2_TRAIN_SEQ[0]} "
          f"under adafactor + qkv_fc1_attn: "
          + ("out of memory" if big is None else
             f"{big['s']:.4f} s, {RUNG_BIG_BATCH / big['s']:.3f} samples/s, "
             f"peak {big['peak_gib']:.2f} GiB")
          + f" on {smi}")
    return {"parity": rel, "ladder": ladder, "big": big or "out of memory"}


def _train_row(torch, cuda_build, name, smi, phase="28"):
    """One of bench.py's training rows (TRAIN_ROWS) through its trainer's
    ``build_trainer`` on the dense route (bench.py's default), the mode
    set by the config keys of ``profile_train.mode_overrides``: a warm
    step, then TRAIN_ROW_STEPS steps on the one batch with fixed draws
    (losses falling), s a step, samples/s, peak memory."""
    from showo_tpu_torch.profile_train import (mode_overrides, stage1_config,
                                               train_batch, v2_batch,
                                               v2_config)

    slice_, mode, rows = TRAIN_ROWS[name]
    overrides = mode_overrides(**mode)
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    if slice_ == "v1":
        from showo_tpu_torch.training.train_showo import build_trainer

        trainer = build_trainer(stage1_config(*overrides), dev,
                                attn_impl="dense")
        batch, noise = train_batch(trainer)
        tc, llm = trainer.tc, trainer.cfg.llm
        rows = sum(trainer.step_fn.sizes)
        fp32 = llm.attn_fp32

        def step():
            return trainer.train_step(*batch, noise=noise)
    else:
        from showo_tpu_torch.show_o2.train_stage_one import build_trainer

        trainer = build_trainer(v2_config(*overrides), dev,
                                attn_impl="dense")
        hb = v2_batch(trainer.model.cfg.num_image_tokens, rows,
                      V2_TRAIN_SEQ[0])
        tc, c = trainer.sc, trainer.model.cfg
        fp32 = c.llm.attn_fp32
        if c.dit.attn_fp32 != fp32:
            raise AssertionError("the towers' softmax dtypes differ")

        def step():
            return trainer.train_step(
                hb, torch.Generator(device="cuda").manual_seed(28))
    if (tc.optimizer, tc.remat, fp32) != (mode["optimizer"], mode["remat"],
                                          mode["softmax"] == "fp32"):
        raise AssertionError(f"{name}: the trainer runs {tc.optimizer}, "
                             f"{tc.remat}, attn_fp32={fp32}, not {mode}")
    setup = time.perf_counter() - t0
    step()                                                    # warm step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    walls, losses = [], []
    for _ in range(TRAIN_ROW_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step()["loss"]))
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launched = {n: c for n, c in cuda_build.launches.items() if c}
    if launched:
        raise AssertionError(f"{name}: the dense route launched {launched}")
    if not (all(x == x and abs(x) < float("inf") for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"{name}: losses not finite and falling on one "
                             f"batch: {losses}")
    wall = statistics.median(walls)
    print(f"[{phase}] {name} ({slice_}, {rows} rows, dense, {mode}; built "
          f"in {setup:.1f} s): losses {[round(x, 4) for x in losses]}; step "
          f"{wall:.4f} s (median of {TRAIN_ROW_STEPS}: "
          f"{', '.join(f'{w:.4f}' for w in walls)}), {rows / wall:.3f} "
          f"samples/s, peak memory allocated {peak:.2f} GiB on {smi}")
    trainer = None
    gc.collect()
    torch.cuda.empty_cache()
    return {"rows": rows, "mode": mode, "step_s": wall, "walls": walls,
            "samples_per_s": rows / wall, "peak_gib": peak,
            "losses": losses}


def _vist_json(tmp, n_images):
    """A VIST json in ``tmp`` of two records over the in-tree image: one
    of ``n_images`` images and sentences, one of one image fewer (its last
    span is (0, 0))."""
    image = os.path.abspath(MMU_IMAGE)
    sentences = ["a cat sat on the mat in the morning sun",
                 "then it walked to the garden and looked at the birds",
                 "a bird flew down from the old tree to the wall",
                 "the cat and the bird watched each other until night"]
    recs = [{"images": [image] * k, "sentences": sentences[:k]}
            for k in (n_images, n_images - 1)]
    path = os.path.join(tmp, "vist.json")
    with open(path, "w") as f:
        json.dump(recs, f)
    return path


def _mixed_want(steps: int, qwen: int, dit: int) -> dict:
    """Kernel 8's launches over ``steps`` mixed-modality steps on
    ``trainable`` at MIXED_SEQ rows (both towers past the packed budget),
    remat "full": two forwards, one dq and one dk/dv a layer, a tile map a
    forward; the Qwen2.5 layers' at head dim 128."""
    fwd, dq, dkv, tiles = list(STREAM_TRAIN_KERNELS)
    layers = qwen + dit
    want = {name: 0 for name in COUNTERS}
    want.update({fwd: 2 * layers * steps, dq: layers * steps,
                 dkv: layers * steps, tiles: 2 * layers * steps,
                 fwd + D128: 2 * qwen * steps, dq + D128: qwen * steps,
                 dkv + D128: qwen * steps})
    return want


def _mixed_batch(config, n_img, tmp):
    """One host batch of the config's batch_size_mixed_modal samples, made
    by VISTDataset at the config's sizes."""
    from showo_tpu_torch.data.loader import default_collate
    from showo_tpu_torch.data.vist_dataset import VISTDataset
    from showo_tpu_torch.inference_t2i_v2 import load_tokenizer_and_ids

    pre = config.dataset.preprocessing
    tokenizer, ids = load_tokenizer_and_ids(config)
    ds = VISTDataset(_vist_json(tmp, MIXED_IMAGES), tmp, tokenizer, ids,
                     resolution=pre.resolution, num_image_tokens=n_img,
                     max_seq_len=pre.max_mixed_modal_seq_length,
                     max_num_images=pre.max_num_images)
    return default_collate([ds[i] for i in range(MIXED_BATCH)])


def phase_mixed_train(torch, cuda_build, smi, phase="29"):
    """Show-o2 1.5B mixed-modality training at full width and depth
    (``configs/showo2_1.5b_downstream_mixed_modality_simple.yaml``, warmup
    0) through ``train_mixed_modality.build_trainer`` on the config's
    route, ``trainable``: a batch of MIXED_BATCH VIST samples of
    MIXED_SEQ rows, MIXED_IMAGES images of 432x432 a sample (one (0, 0)
    span), built by VISTDataset; under the recipe's phase-1 freeze, then
    with ``frozen_params=[]`` (a new optimizer over every weight): a warm
    step and MIXED_STEPS timed steps each, s a step, samples/s, peak
    memory and kernel 8's launches a step (held to the layer counts);
    then one step's losses and grad norm on ``trainable`` against the same
    prepared batch on ``dense`` at phase 25's limits."""
    import tempfile

    from showo_tpu_torch.config import load_config
    from showo_tpu_torch.show_o2 import train_mixed_modality as tmm
    from showo_tpu_torch.show_o2.masks import omni_attn_mask
    from showo_tpu_torch.training.train_step import global_norm

    t0 = time.perf_counter()
    config = load_config(MIXED_CONFIG, ["training.warmup_steps=0"])
    trainer = tmm.build_trainer(config, torch.device("cuda"))
    c, sc = trainer.model.cfg, trainer.sc
    pre = config.dataset.preprocessing
    if not (c.llm.num_layers == V2_QWEN_LAYERS and c.llm.hidden_size == 1536
            and c.dit.num_layers == V2_DIT_LAYERS and sc.attn_impl ==
            "trainable" and sc.remat == "full"
            and pre.max_mixed_modal_seq_length == MIXED_SEQ
            and pre.max_num_images == MIXED_IMAGES
            and pre.resolution == 432
            and config.training.batch_size_mixed_modal == MIXED_BATCH):
        raise AssertionError(f"not the full mixed-modality config: {c}, "
                             f"{sc}")
    print(f"[{phase}] mixed-modality trainer built from {MIXED_CONFIG} "
          f"(warmup 0) in {time.perf_counter() - t0:.1f} s: route "
          f"{sc.attn_impl} (the config's pallas_trainable), remat "
          f"{sc.remat}, frozen {', '.join(trainer.frozen_substrings)}")
    with tempfile.TemporaryDirectory() as tmp:
        batch = _mixed_batch(config, c.num_image_tokens, tmp)
    mp = batch["modality_positions"]
    if not (batch["text_tokens"].shape == (MIXED_BATCH, MIXED_SEQ)
            and batch["images"].shape == (MIXED_BATCH, MIXED_IMAGES, 432,
                                          432, 3)
            and tuple(mp[-1, -1]) == (0, 0)):
        raise AssertionError(f"VIST batch {batch['text_tokens'].shape} "
                             f"{batch['images'].shape} {mp.tolist()}")
    out = {}
    for stage, frozen in (("phase-1 freeze", trainer.frozen_substrings),
                          ("frozen_params=[]", ())):
        if not frozen:
            trainer.frozen_substrings = ()
            trainer.optimizer = trainer.step_fn.optimizer = \
                trainer.make_optimizer()
        gc.collect()
        torch.cuda.empty_cache()
        trainer.train_step(batch, torch.Generator(device="cuda")
                           .manual_seed(29))                # warm step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.launches.clear()
        walls, losses = [], []
        for _ in range(MIXED_STEPS):
            gen = torch.Generator(device="cuda").manual_seed(29)
            t1 = time.perf_counter()
            m = trainer.train_step(batch, gen)
            losses.append(float(m["loss"]))
            walls.append(time.perf_counter() - t1)
        want = _mixed_want(MIXED_STEPS, V2_QWEN_LAYERS, V2_DIT_LAYERS)
        counts = {n: cuda_build.launches[n] for n in want}
        if counts != want:
            raise AssertionError(f"mixed modality ({stage}): launches "
                                 f"{counts}, want {want}")
        if not all(x == x and abs(x) < float("inf") for x in losses):
            raise AssertionError(f"losses not finite: {losses}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        wall = statistics.median(walls)
        n_train = sum(p.numel() for p in trainer.optimizer.params)
        print(f"[{phase}] mixed-modality training ({stage}: {n_train} "
              f"trainable parameters), {MIXED_BATCH} samples x {MIXED_SEQ} "
              f"rows, {MIXED_IMAGES} images of 432x432 a sample, bf16 "
              f"autocast: kernel 8 launches a step "
              f"{_per_step(counts, MIXED_STEPS)}, 0 of the others; losses "
              f"{[round(x, 4) for x in losses]}; step {wall:.4f} s (median "
              f"of {MIXED_STEPS}: {', '.join(f'{w:.4f}' for w in walls)}), "
              f"{MIXED_BATCH / wall:.4f} samples/s, peak memory allocated "
              f"{peak:.2f} GiB on {smi}")
        out[stage] = {"step_s": wall, "samples_per_s": MIXED_BATCH / wall,
                      "peak_gib": peak, "losses": losses, "walls": walls,
                      "trainable": n_train, "counts": counts}
    # one step's parity: the same prepared batch on both routes
    step = trainer.step_fn
    prepared = step.prepare(trainer.device_batch(batch), torch.Generator(
        device="cuda").manual_seed(30))
    L = prepared.text_tokens.shape[1]
    dense = dataclasses.replace(prepared, attn_meta=None, bias=omni_attn_mask(
        prepared.modality_positions, L))
    got = {}
    for route, b in (("trainable", prepared), ("dense", dense)):
        total, parts, grads = step.loss_and_grads(b)
        got[route] = [float(x) for x in (total, *parts, global_norm(grads))]
        del grads
    names = ("loss", "loss_ntp", "loss_flow", "grad_norm")
    rel = {n: abs(a - b) / abs(b) for n, a, b in
           zip(names, got["trainable"], got["dense"])}
    print(f"[{phase}] mixed-modality step parity, trainable vs dense (28 + "
          f"10 layers, {MIXED_BATCH} x {L} rows, every weight trained): "
          + ", ".join(f"{n} {a:.5f} vs {b:.5f} (rel {rel[n]:.2e})"
                      for n, a, b in zip(names, got["trainable"],
                                         got["dense"]))
          + f"; tol {V2_TRAIN_LOSS_TOL} (losses), {V2_TRAIN_GRAD_NORM_TOL} "
          f"(grad norm)")
    bad = [n for n in names if rel[n] > (V2_TRAIN_GRAD_NORM_TOL
                                         if n == "grad_norm"
                                         else V2_TRAIN_LOSS_TOL)]
    if bad:
        raise AssertionError(f"trainable vs dense differ in {bad}: {rel}")
    out["parity"] = rel
    return out


class _Records(logging.Handler):
    """The log records of a run, for the phases that read a warning."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def phase_mixed_cli(torch, cuda_build, phase="30"):
    """The mixed-modality CLI's two-phase recipe, in process
    (``train_mixed_modality.main(argv)``), at full width and a reduced
    depth (2 Qwen2.5, 2 DiT, 2 SigLIP layers; phase 29 has the depth), on
    the config's data shape (2 samples of 4352 rows, 4 images of 432x432):
    phase 1 (the config's freeze) two steps and a checkpoint a step; phase
    2 (``model.frozen_params=[]``) resumes from ``latest``, which must take
    the weights-only fallback (its warning logged) and a fresh optimizer,
    and trains to step 3.  Kernel 8's launches counted."""
    import tempfile

    from showo_tpu_torch.show_o2 import train_mixed_modality as tmm

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        argv = [f"config={MIXED_CONFIG}", "training.warmup_steps=0",
                "model.showo.llm_num_layers=2",
                "model.showo.num_diffusion_layers=2",
                "model.showo.siglip={num_layers: 2}",
                f"dataset.params.mixed_modal_json="
                f"{_vist_json(tmp, MIXED_IMAGES)}",
                f"dataset.params.mixed_modal_image_root={tmp}",
                f"experiment.output_dir={out}", "experiment.save_every=1",
                "experiment.log_every=1"]
        records = _Records()
        logging.getLogger("showo_tpu_torch").addHandler(records)
        try:
            t0 = time.perf_counter()
            cuda_build.launches.clear()
            first = tmm.main(argv + ["training.max_train_steps=2"])
            counts = {n: c for n, c in cuda_build.launches.items() if c}
            frozen = sum(not p.requires_grad
                         for p in first.model.parameters())
            first = None
            mid = time.perf_counter()
            records.messages.clear()
            second = tmm.main(argv + ["model.frozen_params=[]",
                                      "training.max_train_steps=3"])
            end = time.perf_counter()
        finally:
            logging.getLogger("showo_tpu_torch").removeHandler(records)
        fallback = [m for m in records.messages if "WEIGHTS ONLY" in m]
        want = _mixed_want(2, 2, 2)
        if not (fallback and second.global_step == 3
                and second.optimizer.steps == 1 and frozen > 0
                and all(p.requires_grad for p in second.model.parameters())
                and all(counts.get(n, 0) == c for n, c in want.items())):
            raise AssertionError(
                f"mixed-modality CLI: fallback {fallback}, step "
                f"{second.global_step}, optimizer steps "
                f"{second.optimizer.steps}, launches {counts} (want {want})")
        print(f"[{phase}] the mixed-modality CLI at full width, depth 2 / 2 "
              f"/ 2: phase 1 ({frozen} frozen tensors) 2 steps and "
              f"checkpoints in {mid - t0:.1f} s (kernel 8: {counts}); "
              f"phase 2 (frozen_params=[]) resumed from latest with the "
              f"weights-only fallback (\"{fallback[0][:60]}...\"), a fresh "
              f"optimizer, to step 3 in {end - mid:.1f} s")
        second = None
    return {"phase1_s": mid - t0, "phase2_s": end - mid, "counts": counts}


def _v1_data(tmp):
    """Tiny v1 data in ``tmp`` from the in-tree image: an ImageNet-style
    class folder (2 classes x 8 JPEGs), a webdataset tar shard of 12
    (JPEG, caption) samples and a parquet file of 16 documents (when
    pyarrow imports; else None)."""
    import io
    import tarfile

    from PIL import Image

    src = Image.open(MMU_IMAGE).convert("RGB")

    def jpeg(i):
        img = src.rotate(15 * i).resize((288 + 8 * i, 256))
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=90)
        return buf.getvalue()

    root = os.path.join(tmp, "imagenet")
    for c, cls in enumerate(("n01440764_tench", "n01443537_goldfish")):
        os.makedirs(os.path.join(root, cls))
        for i in range(8):
            with open(os.path.join(root, cls, f"{i}.JPEG"), "wb") as f:
                f.write(jpeg(8 * c + i))
    shard = os.path.join(tmp, "cap-00000.tar")
    with tarfile.open(shard, "w") as tf:
        for i in range(12):
            for name, data in ((f"{i:05d}.jpg", jpeg(i)),
                               (f"{i:05d}.txt", f"The image shows a cat "
                                f"number {i} on a mat.".encode())):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError:
        return root, shard, None
    lm = os.path.join(tmp, "lm.parquet")
    pq.write_table(pa.table({"content": [
        " ".join(f"word{j}" for j in range(40 + 9 * i)) for i in range(16)]}),
        lm)
    return root, shard, lm


def phase_v1_cli(torch, cuda_build, smi, phase="31"):
    """The v1 stage-1 CLI (``training/train_showo.py::main(argv)``) on
    ``configs/showo_pretraining_stage1.yaml`` at full width and a reduced
    depth (2 Phi layers; phase 7 has the depth), trainable route (kernel
    7 at 29 x 387): the data through ``_build_loaders`` (the ImageNet-style
    folder, the tar shard through the native reader, the parquet file, or
    an in-memory lm stream where pyarrow does not import); ``save_every``
    1, ``generate_every`` 1 (validation PNGs through T2IPipeline, on
    ``auto`` = dense at 256x256, and the prediction triptychs), the EMA
    on: two steps, then a second run resuming from ``latest`` to step 3,
    its EMA and its three loaders' positions restored."""
    import tempfile

    from showo_tpu_torch.data import native_image, native_tar
    from showo_tpu_torch.training import train_showo

    with tempfile.TemporaryDirectory() as tmp:
        imagenet, shard, lm = _v1_data(tmp)
        index = native_tar.TarIndex(shard)
        jpgs = index.read([i for i, n in enumerate(index.names)
                           if n.endswith(".jpg")])
        _, valid = native_image.decode_batch(jpgs, 256)
        out = os.path.join(tmp, "out")
        argv = [f"config={V1_TRAIN_CONFIG}", "lr_scheduler.params."
                "warmup_steps=0", "training.attn_impl=trainable",
                "model.showo.phi={num_layers: 2}",
                f"dataset.params.train_t2i_shards_path_or_url={imagenet}",
                "dataset.params.train_mmu_shards_path_or_url="
                + shard.replace("00000", "{00000..00000}"),
                f"dataset.params.train_lm_shards_path_or_url="
                f"{lm or 'in-memory'}",
                "dataset.params.shuffle_buffer_size=4",
                "dataset.params.validation_prompts_file=null",
                "validation_prompts=[a photo of a cat, a red car]",
                "training.ema={enabled: true, decay: 0.999}",
                f"experiment.output_dir={out}", "experiment.save_every=1",
                "experiment.generate_every=1", "experiment.log_every=1",
                "experiment.checkpoints_total_limit=2"]
        from showo_tpu_torch.data import refinedweb

        reader = refinedweb.RefinedWebDataset
        if lm is None:
            print(f"[{phase}] pyarrow does not import here: fit gets an "
                  f"in-memory lm stream; the parquet reader is covered by "
                  f"the CPU tests alone")
            refinedweb.RefinedWebDataset = _InMemoryLM
        tar_before = dict(native_tar.paths)
        try:
            t0 = time.perf_counter()
            cuda_build.launches.clear()
            first = train_showo.main(argv + ["training.max_train_steps=2"])
            counts = {n: c for n, c in cuda_build.launches.items() if c}
            ema_steps = first.ema.step
            first = None
            gc.collect()
            torch.cuda.empty_cache()
            mid = time.perf_counter()
            resumed = train_showo.main(argv + ["training.max_train_steps=3"])
            end = time.perf_counter()
        finally:
            refinedweb.RefinedWebDataset = reader
        tar_paths = {k: native_tar.paths[k] - tar_before.get(k, 0)
                     for k in ("native", "tarfile")}
        ckpts = sorted(d for d in os.listdir(out)
                       if d.startswith("checkpoint-"))
        files = sorted(os.listdir(os.path.join(out, ckpts[-1])))
        samples = sorted(os.listdir(os.path.join(out, "samples")))
        preds = sorted(os.listdir(os.path.join(out, "predictions")))
        fwd, dq, dkv, tiles = list(TRAIN_KERNELS)
        want = {fwd: 2 * 2 * 2, dq: 2 * 2, dkv: 2 * 2, tiles: 2 * 2 * 2}
        ok = (ema_steps == 2 and resumed.global_step == 3
              and resumed.ema.step == 3 and resumed.optimizer.steps == 3
              and ckpts == ["checkpoint-2", "checkpoint-3"]
              and {"ema_state.pt", "t2i_state.json", "lm_state.json",
                   "mmu_state.json"} <= set(files)
              and len(samples) == 6 and len(preds) == 3 * 15
              and {n: counts.get(n, 0) for n in want} == want
              and not [n for n in counts if n in COUNTERS and n not in want]
              and tar_paths["native"] > 0 and tar_paths["tarfile"] == 0)
        if not ok:
            raise AssertionError(
                f"v1 CLI: EMA steps {ema_steps}, resumed step "
                f"{resumed.global_step} (EMA {resumed.ema.step}), "
                f"checkpoints {ckpts} {files}, {len(samples)} samples, "
                f"{len(preds)} panels, launches {counts} (want {want}), tar "
                f"paths {tar_paths}")
        decoder = ("loaded" if native_image._lib
                   else "did not build or load here, PIL decoded")
        positions = {}
        for n in ("t2i", "lm", "mmu"):
            with open(os.path.join(out, "checkpoint-3",
                                   f"{n}_state.json")) as f:
                positions[n] = json.load(f)["batches_yielded"]
        print(f"[{phase}] the v1 stage-1 CLI at full width, depth 2, "
              f"trainable (29 x 387 rows: kernel 7): data through "
              f"_build_loaders (ImageNet folder, tar shard on the "
              f"{'native' if tar_paths['native'] else 'tarfile'} reader "
              f"{tar_paths}, {'parquet' if lm else 'in-memory lm stream'}); "
              f"the shard's JPEGs through native_image.decode_batch: "
              f"{sum(valid)} of {len(valid)} decoded, paths "
              f"{dict(native_image.paths)} (the native decoder {decoder}); "
              f"2 steps with a checkpoint, "
              f"validation PNGs and triptychs each, EMA on, in "
              f"{mid - t0:.1f} s (kernel 7: {counts}); resumed from latest "
              f"(EMA step 2, loader positions restored) to step 3 in "
              f"{end - mid:.1f} s; checkpoint-3 holds {files}, loader "
              f"positions {positions}")
        resumed = None
    return {"first_s": mid - t0, "resume_s": end - mid, "counts": counts,
            "tar_paths": tar_paths, "image_paths": dict(native_image.paths),
            "parquet": lm is not None}


class _InMemoryLM:
    """Stands in for ``data/refinedweb.py::RefinedWebDataset`` where pyarrow
    does not import: 16 documents from memory."""

    def __init__(self, *args, **kwargs):
        self.docs = [{"input_ids": " ".join(f"word{j}"
                                            for j in range(40 + 9 * i))}
                     for i in range(16)]

    def __iter__(self):
        return iter(self.docs)


def _conversations(image):
    """LLaVA-OneVision conversation records over the in-tree image: one to
    three rounds, one image each (opening the first turn, as LLaVA's
    records do, or inside a later one)."""
    name = os.path.basename(image)
    convs = [
        [("<image>\nWhat is in this image?", "A small cat on a mat.")],
        [("<image>\nDescribe the picture.", "A cat sits on a woven mat "
          "in the sun."), ("What colour is the cat?", "It is grey.")],
        [("Hello there.", "Hello, how can I help?"),
         ("Look at this <image> closely. What animal is it?", "A cat."),
         ("Is it awake?", "Yes, its eyes are open.")],
        [("Please describe <image> in one sentence.", "A cat rests on a "
          "mat near a wall.")]]
    return [{"image": name, "conversations": [
        {"from": who, "value": text} for q, a in c
        for who, text in (("human", q), ("gpt", a))]} for c in convs]


def _stage2_data(tmp):
    """The stage-2 CLI's data in ``tmp``: a t2i jsonl of four prompts and
    the conversation json, both over the in-tree image."""
    image = os.path.abspath(MMU_IMAGE)
    t2i = os.path.join(tmp, "t2i.jsonl")
    with open(t2i, "w") as f:
        for prompt in ("a photo of a cat", "a red car on a road",
                       "an old stone bridge", "a bowl of fruit"):
            f.write(json.dumps({"path": image, "prompt": prompt}) + "\n")
    mmu = os.path.join(tmp, "llava.json")
    with open(mmu, "w") as f:
        json.dump(_conversations(image), f)
    return [f"dataset.params.t2i_jsonl={t2i}",
            f"dataset.params.annotation_path={mmu}",
            f"dataset.params.mmu_image_root={os.path.dirname(image)}"]


def _parity(torch, step, prepared, phase, label):
    """One step's losses and grad norm on ``trainable`` against ``dense`` on
    the same prepared batch (phase 25's limits)."""
    from showo_tpu_torch.show_o2.masks import omni_attn_mask
    from showo_tpu_torch.training.train_step import global_norm

    L = prepared.text_tokens.shape[1]
    dense = dataclasses.replace(prepared, attn_meta=None, bias=omni_attn_mask(
        prepared.modality_positions, L))
    got = {}
    for route, b in (("trainable", prepared), ("dense", dense)):
        total, parts, grads = step.loss_and_grads(b)
        got[route] = [float(x) for x in (total, *parts, global_norm(grads))]
        del grads
    names = ("loss", "loss_ntp", "loss_flow", "grad_norm")
    rel = {n: abs(a - b) / abs(b) for n, a, b in
           zip(names, got["trainable"], got["dense"])}
    print(f"[{phase}] {label} step parity, trainable vs dense: "
          + ", ".join(f"{n} {a:.5f} vs {b:.5f} (rel {rel[n]:.2e})"
                      for n, a, b in zip(names, got["trainable"],
                                         got["dense"]))
          + f"; tol {V2_TRAIN_LOSS_TOL} (losses), {V2_TRAIN_GRAD_NORM_TOL} "
          f"(grad norm)")
    bad = [n for n in names if rel[n] > (V2_TRAIN_GRAD_NORM_TOL
                                         if n == "grad_norm"
                                         else V2_TRAIN_LOSS_TOL)]
    if bad:
        raise AssertionError(f"{label}: trainable vs dense differ in {bad}: "
                             f"{rel}")
    return rel


def phase_stage2_train(torch, cuda_build, smi, phase="32"):
    """Show-o2 1.5B stage 2 on LLaVA conversations at full width and depth
    (``configs/showo2_1.5b_stage_2_a.yaml``) through
    ``train_stage_two.build_trainer`` on ``trainable``: one batch of the
    CLI's loader (``build_stage2_loader``: 4 t2i jsonl rows and 4
    ``MMUDataset`` rows of 1024 at 432x432, concatenated on their shared
    keys), under the 2a freeze, then with every weight trained (a new
    optimizer): a warm step and STAGE2_STEPS timed ones each, kernel 7's
    launches a step held to the layer counts, s a step, samples/s, peak
    memory, and one step's losses and grad norm against ``dense``."""
    import tempfile

    from showo_tpu_torch.config import load_config
    from showo_tpu_torch.inference_t2i_v2 import load_tokenizer_and_ids
    from showo_tpu_torch.show_o2 import train_stage_two as t2

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        config = load_config(STAGE2_CONFIG, _stage2_data(tmp))
        trainer = t2.build_trainer(config, torch.device("cuda"),
                                   attn_impl="trainable")
        c, sc = trainer.model.cfg, trainer.sc
        if not (c.llm.num_layers == V2_QWEN_LAYERS
                and c.llm.hidden_size == 1536
                and c.dit.num_layers == V2_DIT_LAYERS
                and sc.remat == "full" and sc.attn_impl == "trainable"):
            raise AssertionError(f"not the full stage-2 trainer: {c}, {sc}")
        tok, ids = load_tokenizer_and_ids(config)
        loader = t2.build_stage2_loader(config, tok, ids, trainer.model)
        batch = next(iter(loader))
    mp, types = batch["modality_positions"], list(batch["data_type"])
    n_img = c.num_image_tokens
    if not (batch["text_tokens"].shape == (8, 1024)
            and batch["images"].shape == (8, 432, 432, 3)
            and types == ["t2i"] * 4 + ["mmu"] * 4
            and (mp[:, 0, 1] == n_img).all() and "texts" not in batch):
        raise AssertionError(f"stage-2 batch {batch['text_tokens'].shape} "
                             f"{batch['images'].shape} {types} "
                             f"{mp.tolist()} {sorted(batch)}")
    print(f"[{phase}] stage-2 trainer built from {STAGE2_CONFIG} in "
          f"{time.perf_counter() - t0:.1f} s; the CLI's loader gave 4 t2i "
          f"jsonl rows and 4 conversation rows ({n_img} image tokens each, "
          f"spans at {mp[4:, 0, 0].tolist()}; labelled answer tokens "
          f"{(batch['text_labels'][4:] != -100).sum(1).tolist()}), keys "
          f"{sorted(batch)}")
    for stage, frozen in (("2a freeze", trainer.frozen_substrings),
                          ("frozen_params=[]", ())):
        if not frozen:
            trainer.frozen_substrings = ()
            trainer.optimizer = trainer.step_fn.optimizer = \
                trainer.make_optimizer()
        gc.collect()
        torch.cuda.empty_cache()
        trainer.train_step(batch, torch.Generator(device="cuda")
                           .manual_seed(32))                # warm step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, losses, _, counts = _v2_steps(
            torch, cuda_build, trainer, batch, STAGE2_STEPS, V2_TRAIN_SEQ[0],
            f"stage 2 ({stage})", phase)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        wall = statistics.median(walls)
        n_train = sum(p.numel() for p in trainer.optimizer.params)
        rel = _parity(torch, trainer.step_fn, trainer.step_fn.prepare(
            trainer.device_batch(batch), torch.Generator(device="cuda")
            .manual_seed(33)), phase, f"stage 2 ({stage})")
        print(f"[{phase}] stage-2 training ({stage}: {n_train} trainable "
              f"parameters), 8 rows x 1024 at 432x432, bf16 autocast: "
              f"kernel 7 launches a step {_per_step(counts, STAGE2_STEPS)}, "
              f"0 of the others; losses {[round(x, 4) for x in losses]}; "
              f"step {wall:.4f} s (median of {STAGE2_STEPS}: "
              f"{', '.join(f'{w:.4f}' for w in walls)}), {8 / wall:.4f} "
              f"samples/s, peak memory allocated {peak:.2f} GiB on {smi}")
        out[stage] = {"step_s": wall, "walls": walls, "samples_per_s":
                      8 / wall, "peak_gib": peak, "losses": losses,
                      "trainable": n_train, "counts": counts, "parity": rel}
    trainer = None
    return out


def phase_stage2_cli(torch, cuda_build, phase="33"):
    """The stage-2 CLI (``train_stage_two.main``) with ``annotation_path``
    at full width and depth 2 / 2 / 2, on ``trainable``: two steps with
    ``save_every`` 1, then a resume from ``latest`` to step 3 with the
    loaders' state; kernel 7's launches counted."""
    import tempfile

    from showo_tpu_torch.show_o2 import train_stage_two as t2

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        argv = [f"config={STAGE2_CONFIG}", *_stage2_data(tmp),
                "training.attn_impl=trainable",
                "model.showo.llm_num_layers=2",
                "model.showo.num_diffusion_layers=2",
                "model.showo.siglip={num_layers: 2}",
                f"experiment.output_dir={out}", "experiment.save_every=1",
                "experiment.log_every=1", "experiment.generate_every=null",
                "experiment.checkpoints_total_limit=2"]
        t0 = time.perf_counter()
        cuda_build.launches.clear()
        first = t2.main(argv + ["training.max_train_steps=2"])
        counts = {n: c for n, c in cuda_build.launches.items() if c}
        saved = sorted(d for d in os.listdir(out)
                       if d.startswith("checkpoint-"))
        first = None
        gc.collect()
        torch.cuda.empty_cache()
        mid = time.perf_counter()
        resumed = t2.main(argv + ["training.max_train_steps=3"])
        end = time.perf_counter()
        with open(os.path.join(out, "checkpoint-3",
                               "loader_state.json")) as f:
            positions = [s["batches_yielded"]
                         for s in json.load(f)["loaders"]]
        fwd, dq, dkv, tiles = list(TRAIN_KERNELS)
        want = {fwd: 2 * 4 * 2, dq: 4 * 2, dkv: 4 * 2, tiles: 2 * 4 * 2,
                fwd + D128: 2 * 2 * 2, dq + D128: 2 * 2, dkv + D128: 2 * 2}
        if not (saved == ["checkpoint-1", "checkpoint-2"]
                and resumed.global_step == 3
                and resumed.optimizer.steps == 3 and positions == [3, 3]
                and {n: counts.get(n, 0) for n in want} == want
                and not [n for n in counts if n in COUNTERS
                         and n not in want]):
            raise AssertionError(
                f"stage-2 CLI: checkpoints {saved}, step "
                f"{resumed.global_step}, optimizer steps "
                f"{resumed.optimizer.steps}, loader positions {positions}, "
                f"launches {counts} (want {want})")
        print(f"[{phase}] the stage-2 CLI with annotation_path at full "
              f"width, depth 2 / 2 / 2: 2 steps (4 t2i + 4 conversation "
              f"rows) and checkpoints {saved} in {mid - t0:.1f} s (kernel "
              f"7: {counts}); resumed from latest to step 3 in "
              f"{end - mid:.1f} s, loader positions {positions}")
        resumed = None
    return {"first_s": mid - t0, "resume_s": end - mid, "counts": counts}


def _llava_json(tmp, image):
    """A LLaVA instruction json in ``tmp`` over the in-tree image: its
    records' first two turns are the pretraining caption pairs."""
    recs = _conversations(image)
    path = os.path.join(tmp, "llava.json")
    with open(path, "w") as f:
        json.dump(recs, f)
    pre = [dict(r, conversations=r["conversations"][:2]) for r in recs]
    pre_path = os.path.join(tmp, "llava_pretrain.json")
    with open(pre_path, "w") as f:
        json.dump(pre, f)
    return path, pre_path


def phase_clip_cli(torch, cuda_build, phase="33"):
    """The CLIP-ViT trainer's CLI (``train_showo_clip.main``) on
    ``showo_instruction_tuning_2_w_clip_vit.yaml`` at full width and Phi
    depth 2 (the CLIP-ViT-L/14-336 tower whole), dense: ``llava_pretrain``
    two steps with ``save_every`` 1, then ``llava_tuning`` resuming from
    its ``latest`` to step 3 (weights, optimizer, loaders); the t2i data a
    tar shard, the lm data parquet, as phase 31's; no kernel launches."""
    import tempfile

    from showo_tpu_torch.data import refinedweb
    from showo_tpu_torch.training import train_showo_clip

    image = os.path.abspath(MMU_IMAGE)
    with tempfile.TemporaryDirectory() as tmp:
        _, shard, lm = _v1_data(tmp)
        tuning, pretrain = _llava_json(tmp, image)
        out = os.path.join(tmp, "out")
        argv = [f"config={CLIP_TRAIN_CONFIG}", "model.showo.phi="
                "{num_layers: 2}",
                "dataset.params.train_t2i_shards_path_or_url="
                + shard.replace("00000", "{00000..00000}"),
                f"dataset.params.train_lm_shards_path_or_url="
                f"{lm or 'in-memory'}",
                f"dataset.params.mmu_image_root={os.path.dirname(image)}",
                "dataset.params.shuffle_buffer_size=4",
                f"experiment.output_dir={out}", "experiment.save_every=1",
                "experiment.log_every=1", "experiment.generate_every=null",
                "experiment.checkpoints_total_limit=2"]
        reader = refinedweb.RefinedWebDataset
        if lm is None:
            refinedweb.RefinedWebDataset = _InMemoryLM
        try:
            t0 = time.perf_counter()
            cuda_build.launches.clear()
            first = train_showo_clip.main(argv + [
                "dataset.und_type=llava_pretrain",
                f"dataset.params.train_mmu_shards_path_or_url={pretrain}",
                "training.max_train_steps=2"])
            sys_first, steps_first = first.system_prompt_len, first.global_step
            first = None
            gc.collect()
            torch.cuda.empty_cache()
            mid = time.perf_counter()
            tuned = train_showo_clip.main(argv + [
                "dataset.und_type=llava_tuning",
                f"dataset.params.train_mmu_shards_path_or_url={tuning}",
                "training.max_train_steps=3"])
            end = time.perf_counter()
        finally:
            refinedweb.RefinedWebDataset = reader
        counts = {n: c for n, c in cuda_build.launches.items()
                  if c and n in COUNTERS}
        ckpts = sorted(d for d in os.listdir(out)
                       if d.startswith("checkpoint-"))
        files = sorted(os.listdir(os.path.join(out, ckpts[-1])))
        if not (steps_first == 2 and sys_first == 0
                and tuned.global_step == 3 and tuned.optimizer.steps == 3
                and tuned.system_prompt_len > 0
                and ckpts == ["checkpoint-2", "checkpoint-3"]
                and {"t2i_state.json", "lm_state.json",
                     "mmu_state.json"} <= set(files) and not counts):
            raise AssertionError(
                f"CLIP CLI: steps {steps_first} / {tuned.global_step}, "
                f"system prompt {sys_first} / {tuned.system_prompt_len}, "
                f"checkpoints {ckpts} {files}, kernel launches {counts}")
        print(f"[{phase}] the CLIP-ViT trainer's CLI at full width, Phi "
              f"depth 2 (CLIP-ViT-L/14-336 whole), dense: llava_pretrain 2 "
              f"steps with checkpoints in {mid - t0:.1f} s; llava_tuning "
              f"(system prompt {tuned.system_prompt_len} tokens; on the "
              f"stand-in tokenizer the mismatch guard voids the "
              f"conversations' labels, as in JAX: phase 34 labels them) "
              f"resumed from its latest to step 3 in {end - mid:.1f} s; "
              f"checkpoint-3 holds {files}; no kernel launched")
        tuned = None
    return {"pretrain_s": mid - t0, "tuning_s": end - mid}


class _EndOfTextTokenizer:
    """The v1 stand-in's word ids with ``<|endoftext|>`` its eos id, as
    Phi-1.5's tokenizer reads it.  The stand-in alone glues it to the
    words around it, so the rounds of a LLaVA conversation never add up
    to the whole and the mismatch guard voids every label (as in JAX);
    with it the answers are the targets."""

    def __init__(self, tokenizer):
        from showo_tpu_torch.data.llava import SEP2

        self.tok, self.sep2 = tokenizer, SEP2

    def _row(self, text):
        words = text.replace(self.sep2, f" {self.sep2} ").split()
        return [self.tok.eos_token_id if w == self.sep2
                else self.tok._word_id(w) for w in words]

    def __call__(self, texts, **kwargs):
        return {"input_ids": [self._row(t) for t in texts]}


def _clip_batches(trainer, rows, tmp):
    """Host batches of the CLIP trainer's config sizes: seeded t2i pixels
    and prompts, lm documents, and LLaVA samples of the in-tree image at
    the tower's size (their answers labelled: ``_EndOfTextTokenizer``),
    collated."""
    import numpy as np

    from showo_tpu_torch.data.llava import LLaVADataset
    from showo_tpu_torch.training.train_showo_clip import collate_llava

    n_t2i, n_lm, n_mmu = rows
    rng = np.random.default_rng(34)
    res = trainer.config.dataset.params.resolution
    t2i = {"image": rng.uniform(-1, 1, (n_t2i, res, res, 3)).astype(
        np.float32), "text": [f"a photo of object {i} on a table"
                              for i in range(n_t2i)]}
    lm = [" ".join(f"word{j}" for j in range(300 + 40 * i))
          for i in range(n_lm)]
    image = os.path.abspath(MMU_IMAGE)
    path, _ = _llava_json(tmp, image)
    ds = LLaVADataset(path, os.path.dirname(image), _EndOfTextTokenizer(
        trainer.uni_prompting.text_tokenizer),
        resolution=trainer.clip.cfg.image_size)
    return t2i, lm, collate_llava([ds[i % len(ds)] for i in range(n_mmu)])


def phase_clip_train(torch, cuda_build, smi, phase="34"):
    """The CLIP-ViT trainer's step at full width and depth
    (``showo_instruction_tuning_2_w_clip_vit.yaml``: 3 t2i + 1 lm + 4 mmu
    rows, Phi-1.5 24 layers trained, CLIP-ViT-L/14-336 frozen, dense)
    through ``train_showo_clip.build_trainer``: a warm step and
    CLIP_TRAIN_STEPS timed ones, s a step, samples/s, peak memory, no
    kernel launched; then one step's losses under bf16 autocast against
    the same step in fp32 on the same batch and draws (phase 25's loss
    limit)."""
    import tempfile

    from showo_tpu_torch.config import load_config
    from showo_tpu_torch.training import train_showo_clip

    t0 = time.perf_counter()
    config = load_config(CLIP_TRAIN_CONFIG)
    trainer = train_showo_clip.build_trainer(config, torch.device("cuda"))
    tr, c = config.training, trainer.model.cfg
    rows = (tr.batch_size_t2i, tr.batch_size_lm, tr.batch_size_mmu)
    if not (c.llm.num_layers == 24 and c.llm.hidden_size == 2048
            and trainer.clip.cfg.num_layers == 24
            and trainer.clip.cfg.image_size == 336
            and rows == (3, 1, 4) and trainer.tc.attn_impl == "dense"
            and trainer.step_fn.autocast_dtype == torch.bfloat16):
        raise AssertionError(f"not the full CLIP trainer: {c}, rows {rows}")
    with tempfile.TemporaryDirectory() as tmp:
        batches = _clip_batches(trainer, rows, tmp)
    n_train = sum(p.numel() for p in trainer.optimizer.params)
    print(f"[{phase}] CLIP-ViT trainer built from {CLIP_TRAIN_CONFIG} in "
          f"{time.perf_counter() - t0:.1f} s: {n_train} trainable "
          f"parameters (mm_projector at x{tr.get('projector_lr_scale', 2.0)}"
          f" the rate), system prompt {trainer.system_prompt_len} tokens, "
          f"max_grad_norm {trainer.tc.max_grad_norm}")
    trainer.train_step(*batches, torch.Generator(device="cuda")
                       .manual_seed(34))                    # warm step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    walls, losses = [], []
    for _ in range(CLIP_TRAIN_STEPS):
        gen = torch.Generator(device="cuda").manual_seed(34)
        t1 = time.perf_counter()
        m = trainer.train_step(*batches, gen)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t1)
    counts = {n: c for n, c in cuda_build.launches.items()
              if c and n in COUNTERS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    parts = [float(m[k]) for k in ("loss_t2i", "loss_lm", "loss_mmu")]
    if counts or not all(0 < x < float("inf") for x in losses + parts):
        raise AssertionError(f"CLIP step: launches {counts}, losses {losses}"
                             f", last step's parts {parts}")
    wall = statistics.median(walls)
    n = sum(rows)
    host = trainer.host_batch(*batches)
    step = trainer.step_fn
    got = {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
        step.autocast_dtype = dtype
        b = step.prepare(*host, generator=torch.Generator(device="cuda")
                         .manual_seed(35))
        total, parts, grads = step.loss_and_grads(b)
        got[name] = [float(x) for x in (total, *parts)]
        b = grads = None
    step.autocast_dtype = torch.bfloat16
    names = ("loss", "loss_t2i", "loss_lm", "loss_mmu")
    rel = {k: abs(a - b) / abs(b) for k, a, b in
           zip(names, got["bf16"], got["fp32"])}
    print(f"[{phase}] CLIP-ViT training, {rows[0]} t2i + {rows[1]} lm + "
          f"{rows[2]} mmu rows ({host[0].shape[1]}x{host[0].shape[2]} / "
          f"{host[4].shape[1]}x{host[4].shape[2]} pixels), bf16 autocast, "
          f"remat {trainer.tc.remat}, dense: losses "
          f"{[round(x, 4) for x in losses]}; step {wall:.4f} s (median of "
          f"{CLIP_TRAIN_STEPS}: {', '.join(f'{w:.4f}' for w in walls)}), "
          f"{n / wall:.3f} samples/s, peak memory allocated {peak:.2f} GiB "
          f"on {smi}; no kernel launched; bf16 against fp32 on one batch: "
          + ", ".join(f"{k} {a:.5f} vs {b:.5f} (rel {rel[k]:.2e})"
                      for k, a, b in zip(names, got["bf16"], got["fp32"]))
          + f"; tol {V2_TRAIN_LOSS_TOL}")
    bad = [k for k in names if rel[k] > V2_TRAIN_LOSS_TOL]
    if bad:
        raise AssertionError(f"CLIP step: bf16 vs fp32 differ in {bad}: "
                             f"{rel}")
    trainer = step = host = None
    return {"step_s": wall, "walls": walls, "samples_per_s": n / wall,
            "peak_gib": peak, "losses": losses, "bf16_vs_fp32": rel,
            "trainable": n_train}


EVAL_GENEVAL_PROMPTS, EVAL_GENEVAL_BATCH = 2, 2
EVAL_DPG_BATCH = 4          # one DPG prompt: a 2x2 grid, four crops scored
EVAL_FID_PROMPTS = 4
EVAL_SCORER_TOKENS = 16     # run_quality._build_scorer's answers
# (item, proposition, dependency, tuple, question) of dpg_bench.csv: the
# first data row is skipped (the reference's quirk), then the item's 3
# propositions, the colour depending on the entity
EVAL_DPG_ROWS = [
    ("skipped", 1, "0", "entity - whole (x)", "is there an x?"),
    ("item0", 1, "0", "entity - whole (cat)", "is there a cat?"),
    ("item0", 2, "1", "attribute - color (cat, grey)", "is the cat grey?"),
    ("item0", 3, "0", "entity - whole (mat)", "is there a mat?")]
EVAL_MMU_ITEMS = 4          # the v1 int8 POPE items (and FID references)
EVAL_CLI_TOKENS = 16        # the mmu_eval CLI's answers
EVAL_V2_TOKENS = 20         # the Show-o2 MME answers (the CLI key)
EVAL_CLI_LAYERS = 2         # Phi depth of the CLIs' runs


class _WordDecoder:
    """The stand-in tokenizer's ids back to the words it hashed (those of
    ``words``), ``<id>`` for any other id: the ``decode`` that the DPG
    scorer calls and the stand-in lacks (on the stand-in itself JAX's
    scorer fails the same way and the grid is skipped)."""

    def __init__(self, tokenizer, words):
        self.words = {tokenizer([w])["input_ids"][0][0]: w for w in words}
        self.answers = 0

    def decode(self, ids):
        self.answers += 1
        return " ".join(self.words.get(int(i), f"<{int(i)}>") for i in ids)


def _eval_data(tmp, prompts):
    """The eval chain's items in ``tmp``: a GenEval metadata jsonl, a DPG
    prompt and its csv (dpg_bench.csv's schema), 4 crops of the in-tree
    image as PNGs (the FID references and the understanding images), the
    POPE / MME / GQA jsonl files over them, and the FID prompt file."""
    import csv

    from PIL import Image

    paths = {"geneval": os.path.join(tmp, "geneval.jsonl"),
             "dpg_prompts": os.path.join(tmp, "dpg_prompts"),
             "dpg_csv": os.path.join(tmp, "dpg_bench.csv"),
             "images": os.path.join(tmp, "images"),
             "fid_prompts": os.path.join(tmp, "fid_prompts.txt")}
    with open(paths["geneval"], "w") as f:
        for p in prompts[:EVAL_GENEVAL_PROMPTS]:
            f.write(json.dumps({"prompt": p, "tag": "single_object",
                                "include": [{"class": "cat", "count": 1}]})
                    + "\n")
    with open(paths["fid_prompts"], "w") as f:
        f.write("\n".join(prompts[:EVAL_FID_PROMPTS]) + "\n")
    os.makedirs(paths["dpg_prompts"])
    with open(os.path.join(paths["dpg_prompts"], "item0.txt"), "w") as f:
        f.write("A grey cat sits on a woven mat in the morning sun.\n")
    with open(paths["dpg_csv"], "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["item_id", "proposition_id", "dependency", "tuple",
                    "question_natural_language"])
        w.writerows(EVAL_DPG_ROWS)
    src = Image.open(MMU_IMAGE).convert("RGB")
    os.makedirs(paths["images"])
    for i in range(EVAL_MMU_ITEMS):
        src.crop((32 * i, 16 * i, 32 * i + 384, 16 * i + 384)).save(
            os.path.join(paths["images"], f"im{i}.png"))
    items = {
        "pope": [{"image": f"im{i}.png", "question": "Is there a cat in "
                  "the image?", "answer": ("yes", "no")[i % 2]}
                 for i in range(EVAL_MMU_ITEMS)],
        "mme": [{"image": "im0.png", "question_id": "im0.png",
                 "category": "existence", "question": q, "answer": a}
                for q, a in (("Is there a cat in this image? Please "
                              "answer yes or no.", "yes"),
                             ("Is there a dog in this image? Please "
                              "answer yes or no.", "no"))],
        "gqa": [{"image": f"im{i}.png", "question": "What animal is it?",
                 "answer": "cat"} for i in range(2)]}
    for name, rows in items.items():
        paths[name] = os.path.join(tmp, f"{name}.jsonl")
        with open(paths[name], "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return paths


def _eval_counts(cuda_build):
    return {n: c for n, c in cuda_build.launches.items()
            if c and n in COUNTERS}


def _chain_step(torch, cuda_build, run_quality, pipe, out, steps, want,
                phase, **kw):
    """One ``run_chain`` call: its summary (returned and written alike, no
    step or scoring skipped), its kernel launches (``want``, none of any
    other counter) and its seconds."""
    cuda_build.launches.clear()
    t0 = time.perf_counter()
    summary = run_quality.run_chain(pipe, out, steps, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _eval_counts(cuda_build)
    with open(os.path.join(out, "quality_summary.json")) as f:
        written = json.load(f)
    if not (counts == want and written == json.loads(json.dumps(summary))
            and all(s in summary and "skipped" not in summary[s]
                    and "scoring_skipped" not in summary[s]
                    for s in steps)):
        raise AssertionError(f"[{phase}] run_chain {steps}: launches "
                             f"{counts} (want {want}), summary {summary}")
    return summary, counts, seconds


def phase_eval_chain(torch, np, cuda_build, smi, config, pipe, prompts,
                     data, tmp, phase="35a"):
    """``run_chain`` on phase 14's v1 512x512 pipeline (``build_pipeline``,
    ``auto``: ``packed``, kernel 1) at full width, one step a call:
    GenEval over 2 prompts x batch 2, its first prompt's PNGs bit for bit
    those of a direct ``generate`` with a generator of the same seed; DPG
    over 1 prompt x batch 4, its grid scored by ``MMUPipelineScorer`` on
    ``run_quality._build_scorer``'s bf16 MMU pipeline (the t2i model and
    MAGVIT, 16 tokens an answer: 4 crops x 3 propositions, one dependency);
    FID over 4 validation prompts with the random-projection extractor
    against the 4 crops.  Kernel 1: 384 launches a generate, all on the
    core, 16 tile maps; no other kernel (the scorer's path is dense)."""
    from PIL import Image

    from showo_tpu_torch.evaluation import dpg_bench, fid, run_quality
    from showo_tpu_torch.utils.image import to_pil_images

    c = pipe.cfg
    if not (pipe.attn_route == "packed" and c.llm.num_layers == NUM_LAYERS
            and c.llm.hidden_size == 2048 and c.num_vq_tokens == 1024):
        raise AssertionError(f"[{phase}] not the full-width 512x512 path "
                             f"on packed: {pipe.attn_route}, {c}")

    def want(generates):
        return {KERNELS["packed"][0]: NUM_LAYERS * TIMESTEPS * generates,
                PACKED_WGMMA: NUM_LAYERS * TIMESTEPS * generates,
                PACKED_TILES: TIMESTEPS * generates}

    out = os.path.join(tmp, "quality")
    gen, gen_counts, gen_s = _chain_step(
        torch, cuda_build, run_quality, pipe, os.path.join(out, "geneval"),
        ["geneval"], want(EVAL_GENEVAL_PROMPTS), phase,
        geneval_metadata=data["geneval"], batch_size=EVAL_GENEVAL_BATCH)
    first = os.path.join(gen["geneval"]["outdir"], "00000", "samples")
    saved = [np.asarray(Image.open(os.path.join(first, f)))
             for f in sorted(os.listdir(first))]
    t0 = time.perf_counter()
    direct = to_pil_images(pipe.generate(
        [prompts[0]] * EVAL_GENEVAL_BATCH,
        torch.Generator(device=pipe.device).manual_seed(0)))
    warm_s = time.perf_counter() - t0
    if not (gen["geneval"]["prompts"] == EVAL_GENEVAL_PROMPTS
            and len(saved) == EVAL_GENEVAL_BATCH
            and all(a.shape == (512, 512, 3) and np.array_equal(
                a, np.asarray(b)) for a, b in zip(saved, direct))):
        raise AssertionError(f"[{phase}] GenEval {gen}: the first prompt's "
                             f"PNGs differ from a direct generate")

    mmu = run_quality._build_scorer(config, "v1", pipe).pipe
    words = {w.strip("?") for row in EVAL_DPG_ROWS
             for w in row[4].split()} | {"yes", "no"}
    decoder = _WordDecoder(pipe.uni_prompting.text_tokenizer, words)
    scorer = dpg_bench.MMUPipelineScorer(mmu, decoder,
                                         resolution=pipe.resolution)
    dpg, dpg_counts, dpg_s = _chain_step(
        torch, cuda_build, run_quality, pipe, os.path.join(out, "dpg"),
        ["dpg"], want(1), phase, dpg_prompts_dir=data["dpg_prompts"],
        dpg_csv=data["dpg_csv"], dpg_scorer=scorer,
        batch_size=EVAL_DPG_BATCH, dpg_resolution=pipe.resolution)
    result = dpg["dpg"]["result"]
    questions = EVAL_DPG_BATCH * (len(EVAL_DPG_ROWS) - 1)
    grid = Image.open(os.path.join(dpg["dpg"]["outdir"], "item0.png"))
    if not (result["n"] == 1 and decoder.answers == questions
            and mmu.max_new_tokens == EVAL_SCORER_TOKENS
            and grid.size == (1024, 1024)
            and set(result["l1"]) == {"entity", "attribute"}):
        raise AssertionError(f"[{phase}] DPG {dpg}: {decoder.answers} "
                             f"answers (want {questions}), grid "
                             f"{grid.size}")

    fid_prompts = prompts[:EVAL_FID_PROMPTS]
    fd, fid_counts, fid_s = _chain_step(
        torch, cuda_build, run_quality, pipe, os.path.join(out, "fid"),
        ["fid"], want(EVAL_FID_PROMPTS // EVAL_GENEVAL_BATCH), phase,
        fid_prompts=fid_prompts, fid_ref_dir=data["images"],
        fid_extractor=fid.RandomProjectionExtractor(),
        batch_size=EVAL_GENEVAL_BATCH)
    if not (np.isfinite(fd["fid"]["value"]) and fd["fid"]["value"] > 0
            and fd["fid"]["n_gen"] == EVAL_FID_PROMPTS
            and fd["fid"]["n_ref"] == EVAL_MMU_ITEMS):
        raise AssertionError(f"[{phase}] FID {fd}")
    counts = {n: gen_counts[n] + dpg_counts[n] + fid_counts[n]
              for n in want(1)}
    generates = (EVAL_GENEVAL_PROMPTS + 1
                 + EVAL_FID_PROMPTS // EVAL_GENEVAL_BATCH)
    print(f"[{phase}] run_chain on phase 14's v1 512x512 pipeline (auto: "
          f"packed, full width, bf16, random weights): GenEval "
          f"{EVAL_GENEVAL_PROMPTS} prompts x batch {EVAL_GENEVAL_BATCH} in "
          f"{gen_s:.2f} s ({gen_s / EVAL_GENEVAL_PROMPTS:.4f} s a prompt, "
          f"the pipeline's first generates), the first prompt's PNGs "
          f"identical to a direct generate with a generator of the same "
          f"seed ({warm_s:.4f} s, warm, PNGs not written); DPG 1 prompt x "
          f"batch "
          f"{EVAL_DPG_BATCH}, its 2x2 grid scored by MMUPipelineScorer on "
          f"the bf16 MMU pipeline of the same model ({questions} answers "
          f"of {EVAL_SCORER_TOKENS} tokens; score {result['score']:.2f}, "
          f"l1 {result['l1']}) in {dpg_s:.2f} s; FID ({EVAL_FID_PROMPTS} "
          f"generated at batch {EVAL_GENEVAL_BATCH} against "
          f"{EVAL_MMU_ITEMS} crops, random-projection features) "
          f"{fd['fid']['value']:.4f} in {fid_s:.2f} s; kernel 1 launches "
          f"{counts} over {generates} generates (384 a generate, all on "
          f"the core, 16 tile maps), 0 of the others; on {smi}")
    return {"geneval_s": gen_s, "geneval_s_per_prompt":
            gen_s / EVAL_GENEVAL_PROMPTS, "warm_generate_s": warm_s,
            "dpg_s": dpg_s, "fid_s": fid_s,
            "fid": fd["fid"]["value"], "dpg": result, "counts": counts,
            "generates": generates}


def _mmu_eval_run(torch, cuda_build, mmu_eval, pipe, jsonl, data, out,
                  benchmark, phase):
    """``run_mmu_eval`` over ``jsonl``: (metrics, launches, seconds); the
    metrics file equal to the returned dict, one prediction an item."""
    cuda_build.launches.clear()
    t0 = time.perf_counter()
    metrics = mmu_eval.run_mmu_eval(pipe, jsonl, data["images"], out,
                                    benchmark=benchmark)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _eval_counts(cuda_build)
    with open(os.path.join(out, "metrics_0.json")) as f:
        written = json.load(f)
    with open(os.path.join(out, "predictions_0.jsonl")) as f:
        preds = [json.loads(line) for line in f]
    with open(jsonl) as f:
        n = sum(1 for line in f if line.strip())
    if written != metrics or len(preds) != n or not all(
            isinstance(p["prediction"], str) for p in preds):
        raise AssertionError(f"[{phase}] {benchmark}: metrics {metrics} / "
                             f"{written}, {len(preds)} predictions of {n}")
    return metrics, counts, seconds, n


def phase_eval_mmu_v1(torch, cuda_build, smi, pipe, data, tmp,
                      phase="35b"):
    """``run_mmu_eval`` on phase 10's int8 v1 pipeline (``showo_demo.yaml``
    through ``inference_mmu.build_pipeline``, which the CLI's
    ``mmu_eval.build_pipeline`` calls for v1) at full width: 4 POPE items,
    100 greedy tokens an answer: kernel 9's prefill kernel once a product
    an answer (49), the gemv 49 a token (4900 an answer), none of any
    other kernel."""
    from showo_tpu_torch.evaluation import mmu_eval
    from showo_tpu_torch.models.phi import Int8Linear

    phi = pipe.model.showo
    if not (phi.cfg.num_layers == NUM_LAYERS and phi.cfg.hidden_size == 2048
            and isinstance(phi.lm_head, Int8Linear)
            and pipe.max_new_tokens == MMU_NEW_TOKENS and pipe.top_k == 1):
        raise AssertionError(f"[{phase}] not the full-width int8 v1 "
                             f"pipeline: {phi.cfg}")
    v1, v1_counts, v1_s, n = _mmu_eval_run(
        torch, cuda_build, mmu_eval, pipe, data["pope"], data,
        os.path.join(tmp, "pope"), "pope", phase)
    want = {"int8_matmul": n * MMU_MATMULS * (1 + MMU_NEW_TOKENS),
            PREFILL_KERNEL: n * MMU_MATMULS,
            "int8_matmul_gemv": n * MMU_MATMULS * MMU_NEW_TOKENS}
    if v1_counts != want or set(v1) != {"accuracy", "precision", "recall",
                                        "f1", "yes_ratio", "num"}:
        raise AssertionError(f"[{phase}] v1 POPE: launches {v1_counts} "
                             f"(want {want}), metrics {v1}")
    print(f"[{phase}] run_mmu_eval, v1 int8 (phase 10's pipeline, "
          f"showo_demo.yaml, full width): {n} POPE items of "
          f"{MMU_NEW_TOKENS} greedy tokens in {v1_s:.2f} s ({v1_s / n:.3f} "
          f"s an item), metrics {v1}; kernel 9 launches {v1_counts} = {n} "
          f"x ({MMU_MATMULS} on the prefill kernel + {MMU_MATMULS} x "
          f"{MMU_NEW_TOKENS} on the gemv), 0 of the others; on {smi}")
    return {"v1_int8_pope_s": v1_s, "v1_s_per_item": v1_s / n,
            "v1_metrics": v1, "counts": v1_counts}


def phase_eval_mmu_v2(torch, cuda_build, smi, pipe, data, tmp,
                      phase="35b"):
    """``run_mmu_eval`` on phase 18's bf16 Show-o2 understanding pipeline
    (the model the CLI's ``v2=1`` builds: bf16, no int8, dense as in JAX,
    so no kernel) at 20 greedy tokens an answer: 2 MME questions about one
    image."""
    from showo_tpu_torch.evaluation import mmu_eval

    pipe = dataclasses.replace(pipe, max_new_tokens=EVAL_V2_TOKENS)
    if not (pipe.top_k == 1 and pipe.top_p is None
            and not pipe.quantize_int8 and pipe.resolution == 432
            and pipe.cfg.llm.num_layers == V2_QWEN_LAYERS):
        raise AssertionError(f"[{phase}] not the CLI's Show-o2 pipeline: "
                             f"{pipe.top_k}, {pipe.top_p}, "
                             f"{pipe.quantize_int8}, {pipe.resolution}")
    v2, v2_counts, v2_s, n2 = _mmu_eval_run(
        torch, cuda_build, mmu_eval, pipe, data["mme"], data,
        os.path.join(tmp, "mme"), "mme", phase)
    if v2_counts or set(v2) != {"existence", "total"}:
        raise AssertionError(f"[{phase}] Show-o2 MME: launches {v2_counts}"
                             f", metrics {v2}")
    print(f"[{phase}] run_mmu_eval, Show-o2 (phase 18's bf16 pipeline, "
          f"dense, full width): {n2} MME questions about one 432x432 "
          f"image, {EVAL_V2_TOKENS} greedy tokens each, in {v2_s:.2f} s "
          f"({v2_s / n2:.3f} s an item), metrics {v2}; no kernel launched; "
          f"on {smi}")
    return {"v2_mme_s": v2_s, "v2_s_per_item": v2_s / n2, "v2_metrics": v2}


def _eval_cli(cuda_build, main, argv, want, phase):
    """A CLI's ``main(argv)`` in this process: its last line of output
    (JSON), its kernel launches (``want``, none of any other counter) and
    its seconds."""
    import io

    out = io.StringIO()
    cuda_build.launches.clear()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        main(argv)
    seconds = time.perf_counter() - t0
    counts = _eval_counts(cuda_build)
    if counts != want:
        raise AssertionError(f"[{phase}] {main.__module__}: launches "
                             f"{counts}, want {want}")
    return json.loads(out.getvalue().strip().splitlines()[-1]), seconds


def _eval_cli_process(module, argv, phase):
    """``python -X importtime -m module argv`` in a fresh interpreter from
    the checkout's root (CUDA, the CLI's default device): its last line of
    output (JSON), its seconds, and the modules it imported, none of JAX
    or the JAX package."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", module, *argv],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"[{phase}] python -m {module}: rc "
                             f"{run.returncode}\n{run.stderr[-4000:]}")
    imported = {line.rsplit("|", 1)[-1].strip()
                for line in run.stderr.splitlines()
                if line.startswith("import time:")}
    bad = sorted(m for m in imported
                 if m.split(".")[0] in ("jax", "jaxlib", "showo_tpu"))
    if bad:
        raise AssertionError(f"[{phase}] python -m {module} imported {bad}")
    return json.loads(run.stdout.strip().splitlines()[-1]), seconds, imported


def phase_eval_cli(np, cuda_build, data, tmp, smi, phase="35c"):
    """The two CLIs at full width and Phi depth 2 (as phase 33 cuts its
    CLIs): ``run_quality``'s ``main`` in this process (the 512x512
    pipeline on ``auto``, GenEval and FID with the smoke extractor over the
    4-prompt file: 4 generates, kernel 1 2 x 16 launches each), and
    ``mmu_eval`` (the v1 int8 pipeline, 2 GQA items of 16 tokens: kernel
    9, 5 products a forward) both by its ``main`` in this process, its
    launches counted, and as ``python -m`` in a fresh interpreter: the same
    metrics and prediction file, the kernel 9 wrapper imported, nothing of
    JAX."""
    from showo_tpu_torch.evaluation import mmu_eval, run_quality

    out = os.path.join(tmp, "cli_quality")
    generates = EVAL_GENEVAL_PROMPTS + EVAL_FID_PROMPTS // EVAL_GENEVAL_BATCH
    steps = EVAL_CLI_LAYERS * TIMESTEPS * generates
    summary, rq_s = _eval_cli(cuda_build, run_quality.main, [
        "config=configs/showo_demo_512x512.yaml", "steps=geneval,fid",
        "fid_extractor=smoke", f"output_dir={out}",
        f"geneval_metadata={data['geneval']}",
        f"fid_ref_dir={data['images']}",
        f"validation_prompts_file={data['fid_prompts']}",
        f"batch_size={EVAL_GENEVAL_BATCH}", "guidance_scale=1.75",
        f"generation_timesteps={TIMESTEPS}",
        f"model.showo.phi={{num_layers: {EVAL_CLI_LAYERS}}}"],
        {KERNELS["packed"][0]: steps, PACKED_WGMMA: steps,
         PACKED_TILES: TIMESTEPS * generates}, phase)
    with open(os.path.join(out, "quality_summary.json")) as f:
        written = json.load(f)
    if not (written == summary
            and summary["geneval"]["prompts"] == EVAL_GENEVAL_PROMPTS
            and summary["fid"]["n_gen"] == EVAL_FID_PROMPTS
            and np.isfinite(summary["fid"]["value"])):
        raise AssertionError(f"[{phase}] run_quality CLI: {summary}")
    products = 2 * EVAL_CLI_LAYERS + 1
    items = 2

    def mmu_argv(outdir):
        return ["config=configs/showo_demo.yaml", f"eval_jsonl={data['gqa']}",
                f"image_root={data['images']}", f"outdir={outdir}",
                "benchmark=gqa", "int8=1",
                f"max_new_tokens={EVAL_CLI_TOKENS}", "top_k=1",
                f"model.showo.phi={{num_layers: {EVAL_CLI_LAYERS}}}"]

    runs = {"in": os.path.join(tmp, "cli_mmu"),
            "process": os.path.join(tmp, "cli_mmu_process")}
    metrics, me_s = _eval_cli(cuda_build, mmu_eval.main, mmu_argv(runs["in"]),
        {"int8_matmul": items * products * (1 + EVAL_CLI_TOKENS),
         PREFILL_KERNEL: items * products,
         "int8_matmul_gemv": items * products * EVAL_CLI_TOKENS}, phase)
    process, process_s, imported = _eval_cli_process(
        "showo_tpu_torch.evaluation.mmu_eval", mmu_argv(runs["process"]),
        phase)
    files = {}
    for run, outdir in runs.items():
        for name in ("metrics_0.json", "predictions_0.jsonl"):
            with open(os.path.join(outdir, name)) as f:
                files[run, name] = f.read()
    if not (json.loads(files["in", "metrics_0.json"]) == metrics == process
            and metrics["num"] == items
            and files["in", "predictions_0.jsonl"]
            == files["process", "predictions_0.jsonl"]
            and "showo_tpu_torch.ops.int8_matmul" in imported):
        raise AssertionError(f"[{phase}] mmu_eval CLI: {metrics} in "
                             f"process, {process} from python -m, files "
                             f"{files}")
    print(f"[{phase}] the CLIs at full width, Phi depth "
          f"{EVAL_CLI_LAYERS}: run_quality main steps=geneval,fid "
          f"fid_extractor=smoke in {rq_s:.1f} s (GenEval "
          f"{summary['geneval']['prompts']} prompts, FID "
          f"{summary['fid']['value']:.4f} over {summary['fid']['n_gen']} "
          f"images; kernel 1 {steps} launches over {generates} generates); "
          f"mmu_eval main benchmark=gqa int8=1 in {me_s:.1f} s (metrics "
          f"{metrics}; kernel 9 {items} x {products} x "
          f"{1 + EVAL_CLI_TOKENS} launches), then python -m "
          f"showo_tpu_torch.evaluation.mmu_eval with the same arguments in "
          f"a fresh interpreter in {process_s:.1f} s: the same metrics and "
          f"predictions, {len(imported)} modules imported, none of JAX or "
          f"showo_tpu; on {smi}")
    return {"run_quality_s": rq_s, "mmu_eval_s": me_s,
            "mmu_eval_process_s": process_s}


def phase_vq_psnr(torch, np, smi, phase="35d"):
    """The VQ PSNR gate (``evaluation/vq_psnr.py``) at 256x256 on the
    full-width MAGVIT-v2 (random init from its seed), fp32: the round trip
    returns the input's shape, finite; the CLI's own run prints the same
    PSNR."""
    import io

    from PIL import Image

    from showo_tpu_torch.evaluation import vq_psnr
    from showo_tpu_torch.models.magvit import VQConfig
    from showo_tpu_torch.utils.image import image_transform

    t0 = time.perf_counter()
    vq, tag = vq_psnr.load_codec("", torch.device("cuda"))
    pixels = image_transform(Image.open(MMU_IMAGE).convert("RGB"), 256)[None]
    recon = vq_psnr.roundtrip(vq, pixels)
    value = vq_psnr.psnr(pixels, recon)
    seconds = time.perf_counter() - t0
    if not (vq.cfg == VQConfig() and tag == "random-init"
            and recon.shape == pixels.shape == (1, 256, 256, 3)
            and np.isfinite(recon).all() and np.isfinite(value)):
        raise AssertionError(f"[{phase}] VQ round trip {recon.shape} of "
                             f"{pixels.shape}, PSNR {value}, {tag}")
    vq = None
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        printed = vq_psnr.main(["resolution=256"])
    line = out.getvalue().strip()
    if printed != value or not line.startswith(f"vq_roundtrip_psnr="
                                               f"{value:.2f} dB"):
        raise AssertionError(f"[{phase}] the CLI printed {line!r}, the "
                             f"round trip gave {value}")
    print(f"[{phase}] VQ PSNR gate, full-width MAGVIT-v2 (random init), "
          f"256x256 in-tree image, fp32: {line}; round trip "
          f"{recon.shape} in {seconds:.2f} s; on {smi}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"psnr_db": value, "s": seconds}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np

    from showo_tpu_torch import inference_t2i
    from showo_tpu_torch.config import load_config
    from showo_tpu_torch.ops import cuda_build
    from showo_tpu_torch.profile_train import (stage1_config, train_batch,
                                               tuning512_config)
    from showo_tpu_torch.training.train_showo import build_trainer

    device = torch.device("cuda")
    t_start = time.perf_counter()
    parts = []      # (part of the run, its end time): the [end] line's split

    # [1] device
    smi = _nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1] device: {smi} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | TF32 off (matmul and cuDNN) for the "
          f"parity phases")

    # [2] build: one nvcc per source, all started together
    t0 = time.perf_counter()
    names = [name for name, _ in KERNELS.values()] + [
        TRAIN_SOURCE, STREAM_TRAIN_SOURCE, *WSMM_KERNELS, GQA_SOURCE]
    cuda_build.load_libraries(names)
    print(f"[2] build: {len(names)} sources with nvcc (sm_90a) in parallel, "
          f"{time.perf_counter() - t0:.2f} s")
    for name in names:
        info = cuda_build.build_info[name]
        regs = _ptxas(info["log"]) or [info["log"]]
        print(f"[2]   csrc/{name}.cu {info['seconds']:.2f} s; ptxas: "
              f"{' | '.join(regs)}")
    parts.append(("device + build [1-2]", time.perf_counter()))

    # [3] kernel vs plain
    config = load_config("configs/showo_demo_512x512.yaml",
                         ["guidance_scale=1.75",
                          f"generation_timesteps={TIMESTEPS}"])
    prompts = inference_t2i.load_prompts(config)[:BATCH]
    results = phase_kernels(torch, inference_t2i.build_prompting(config),
                            prompts, inference_t2i.build_showo_config(config),
                            device)

    # [4] the slice through the CLI's build_pipeline, once per route
    route_launches, pipe = {}, None
    for route in KERNELS:
        pipe = None
        gc.collect()
        torch.cuda.empty_cache()
        pipe, route_launches[route] = phase_slice(
            torch, np, inference_t2i, cuda_build, config, prompts, route, smi)

    # [5] step parity, every route, on the last pipeline's weights
    phase_step_parity(torch, pipe, prompts, device)
    pipe = None
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("t2i 512x512 [3-5]", time.perf_counter()))

    # [14] inpainting and extrapolation at 512x512, on the CLI's pipeline
    base = inference_t2i.build_pipeline(config, device=device)
    mode_launches, extra_launches = phase_v1_modes(
        torch, np, cuda_build, base, prompts, smi)
    parts.append(("t2i modes [14]", time.perf_counter()))

    # [35a] the evaluation chain's run_chain (GenEval, DPG with its
    # scoring, FID) on the same pipeline; phase 35's items in a temporary
    # directory that lives until 35c
    eval_tmp = tempfile.TemporaryDirectory()
    eval_prompts = [p for p in inference_t2i.load_prompts(config)
                    if p.strip()]
    eval_data = _eval_data(eval_tmp.name, eval_prompts)
    evaluation = {"chain": phase_eval_chain(
        torch, np, cuda_build, smi, config, base, eval_prompts, eval_data,
        eval_tmp.name)}
    base = None
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("evaluation chain [35a]", time.perf_counter()))

    # the training phases: cuDNN convolutions (the frozen MAGVIT encoder)
    # back on PyTorch's default TF32; matmuls stay full fp32 (the dense
    # route's fp32 scores, the plain versions)
    torch.backends.cudnn.allow_tf32 = True
    trainer, batch, noise, meta = _trainer(
        torch, build_trainer, train_batch, stage1_config(),
        "configs/showo_pretraining_stage1.yaml", (29, 387), 6)

    # [6] kernel 7 vs plain, on the fused batch's metadata
    train_results = phase_train_kernels(torch, meta, 7, "stage-1", 6)

    # [7] the stage-1 training slice through build_trainer / train_step
    train_launches = phase_train(torch, cuda_build, trainer, batch, noise,
                                 smi, "stage-1", TRAIN_KERNELS, 7)

    # [8] trainable vs dense, one full-width step
    phase_train_parity(torch, trainer, batch, noise, 8, TRAIN_LOSS_TOL,
                       GRAD_NORM_TOL)
    trainer = batch = noise = meta = None      # frees the stage-1 trainer
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("stage-1 trainer [6-8]", time.perf_counter()))

    trainer, batch, noise, meta = _trainer(
        torch, build_trainer, train_batch, tuning512_config(),
        "configs/showo_instruction_tuning_1_512x512.yaml", (12, 1408), "6b")

    # [6b] kernel 8 vs plain, on the 512x512 fused batch's metadata
    stream_results = phase_train_kernels(torch, meta, 8, "512x512", "6b")
    meta = None

    # [7b] the 512x512 training slice
    stream_launches = phase_train(torch, cuda_build, trainer, batch, noise,
                                  smi, "512x512", STREAM_TRAIN_KERNELS, "7b")

    # [8b] trainable vs dense, one full-width 512x512 step
    phase_train_parity(torch, trainer, batch, noise, "8b",
                       TRAIN512_LOSS_TOL, TRAIN512_GRAD_NORM_TOL)
    trainer = batch = noise = None
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("512x512 trainer [6b-8b]", time.perf_counter()))

    # the understanding slice (configs/showo_demo.yaml: 256x256, the full
    # MAGVIT-v2 encoder), bf16 and int8 pipelines on the same seeded weights
    from PIL import Image

    from showo_tpu_torch import inference_mmu
    from showo_tpu_torch.models.clip_vit import ClipVisionTower, ClipVitConfig
    from showo_tpu_torch.profile_t2i import profile as profile_all

    def profile(fn, label):
        return profile_all(fn, label, by_operator=False)
    from showo_tpu_torch.utils.image import clip_image_transform

    from showo_tpu_torch.models.phi import fuse_parallel_mlp

    mmu_args = [f"max_new_tokens={MMU_NEW_TOKENS}", "top_k=1"]
    mmu_config = load_config("configs/showo_demo.yaml", mmu_args)
    pipes = {int8: inference_mmu.build_pipeline(load_config(
        "configs/showo_demo.yaml", mmu_args + [f"int8={int8}"]), device)
        for int8 in (0, 1)}
    image = _mmu_image(256)
    prefill_rows = pipes[0].prompt(image, MMU_QUESTION)[0].shape[1]

    # [9] kernels 9-11 vs plain at the slice's shapes (and kernel 9 at the
    # Show-o2 understanding slice's)
    wsmm = phase_wsmm(torch, cuda_build, prefill_rows)
    parts.append(("kernels 9-11 [9]", time.perf_counter()))

    # [10] the discrete mmu slice, bf16 then int8 weights
    mmu = {}
    for int8, pipe in pipes.items():
        gen = torch.Generator(device=device).manual_seed(0)
        mmu[int8] = phase_mmu(
            torch, cuda_build, profile, pipe,
            f"mmu discrete path, {'int8' if int8 else 'bf16'} weights",
            lambda: pipe.answer(image, MMU_QUESTION, gen),
            lambda: pipe.prompt(image, MMU_QUESTION), int8, smi, 10)
    phase_mmu_turns(torch, pipes, image, mmu, device)
    parts.append(("v1 understanding [10]", time.perf_counter()))

    # [11] int8, bf16 and fp32 prefill logits, same prompt and seeded
    # weights (the fp32 model as build_pipeline initialises it)
    cfg = inference_t2i.build_showo_config(mmu_config)
    model32 = inference_t2i.load_model(mmu_config, cfg, device, torch.float32)
    fuse_parallel_mlp(model32.showo)
    phase_int8_parity(torch, pipes[0], pipes[1], model32.showo, image)
    model32 = None
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("int8 logits [11]", time.perf_counter()))

    # [35b] run_mmu_eval on phase 10's int8 pipeline
    evaluation["mmu"] = phase_eval_mmu_v1(torch, cuda_build, smi, pipes[1],
                                          eval_data, eval_tmp.name)
    pipes = pipe = None
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("evaluation, v1 int8 [35b]", time.perf_counter()))

    # [10b] the CLIP-ViT path (configs/showo_demo_w_clip_vit.yaml), int8
    clip_config = load_config("configs/showo_demo_w_clip_vit.yaml",
                              mmu_args + ["int8=1"])
    pipe = inference_mmu.build_pipeline(clip_config, device)
    tower, size = inference_mmu.build_clip(clip_config, device)
    if not (isinstance(tower, ClipVisionTower) and tower.cfg == ClipVitConfig()
            and pipe.cfg.w_clip_vit and pipe.cfg.clip_feat_dim == 1024):
        raise AssertionError("not the CLIP-L/14-336 path at full width")
    px = torch.as_tensor(clip_image_transform(
        Image.open(MMU_IMAGE).convert("RGB"), size), device=device)[None]
    feats = tower(px)[0]
    if tuple(feats.shape) != (576, 1024) or not torch.isfinite(feats).all():
        raise AssertionError(f"CLIP features {tuple(feats.shape)} or not "
                             f"finite")
    clip_ms = _wall_ms(torch, lambda: tower(px))
    print(f"[10b] CLIP-L/14-336 tower (23 of 24 layers, bf16): features "
          f"{tuple(feats.shape)} of a {size}x{size} image in {clip_ms:.2f} "
          f"ms (median of 5)")
    sys_ids = inference_mmu.system_prompt_ids(pipe)
    gen = torch.Generator(device=device).manual_seed(0)
    clip = phase_mmu(
        torch, cuda_build, profile, pipe, "mmu CLIP-ViT path, int8 weights",
        lambda: pipe.answer_with_clip(feats, MMU_QUESTION, sys_ids, gen),
        lambda: pipe.clip_prompt(feats, MMU_QUESTION, sys_ids), 1, smi, "10b")
    if clip["rows"] != CLIP_PREFILL_ROWS:
        raise AssertionError(f"CLIP-ViT prompt rows {clip['rows']}, phase 9 "
                             f"timed {CLIP_PREFILL_ROWS}")
    pipe = tower = feats = None
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("CLIP-ViT [10b]", time.perf_counter()))

    # the Show-o2 432x432 slice through the CLI's build_pipeline
    from showo_tpu_torch import inference_t2i_v2

    v2_config = load_config(V2_CONFIG)
    t0 = time.perf_counter()
    pipe = inference_t2i_v2.build_pipeline(v2_config, device)
    torch.cuda.synchronize()
    print(f"[12] Show-o2 pipeline built in {time.perf_counter() - t0:.1f} s "
          f"(random weights from seeds): "
          f"{sum(p.numel() for p in pipe.model.parameters())} parameters, "
          f"VAE {sum(p.numel() for p in pipe.vae.parameters())}")
    v2_prompts = inference_t2i_v2.load_prompts(v2_config)[:V2_BATCH]

    # [3c] kernels 1 and 6 at the slice's shapes
    v2_results = phase_v2_kernels(torch, pipe, v2_prompts)

    # [12] the slice, [13] packed vs dense velocity
    v2_launches, v2_slice = phase_v2_slice(torch, np, cuda_build, pipe,
                                           v2_prompts, smi)
    phase_v2_parity(torch, pipe, v2_prompts)
    parts.append(("Show-o2 [3c, 12, 13]", time.perf_counter()))

    # [15] kernels 1 and 5 at the cached shapes; [16] the prefix cache,
    # [17] the samplers and the streaming route, on phase 13's weights
    cached_results = phase_v2_cached_kernels(torch, pipe, v2_prompts)
    cached_launches, cached_slice, z, ref, euler_s = phase_v2_cached(
        torch, np, cuda_build, pipe, v2_prompts, smi)
    stream_launches_v2, stream_cached_v2, samplers = phase_v2_samplers(
        torch, np, cuda_build, pipe, v2_prompts, smi, z, ref, euler_s)
    pipe = None
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("Show-o2 cache, samplers [15-17]", time.perf_counter()))

    # [18] Show-o2 image understanding through inference_mmu_v2's
    # build_pipeline, bf16, then int8 on a copy of the model; int8 prefill
    # logits against the fp32 model of the same seeds
    from showo_tpu_torch import inference_mmu_v2, inference_mmu_vid

    und_config = load_config(V2_CONFIG, mmu_args)
    pipe = inference_mmu_v2.build_pipeline(und_config, device)
    pipe_i8 = dataclasses.replace(pipe, model=copy.deepcopy(pipe.model),
                                  quantize_int8=True)
    v2_image = _mmu_image(pipe.resolution)
    und = {}
    und[0], _ = phase_mmu_v2(torch, cuda_build, profile, pipe, v2_image, 0,
                             smi)
    und[1], (embeds, bias) = phase_mmu_v2(torch, cuda_build, profile,
                                          pipe_i8, v2_image, 1, smi)
    qwen32 = inference_t2i_v2.load_model(und_config, pipe.cfg, device,
                                         torch.float32).showo
    und_parity = phase_mmu_v2_parity(torch, pipe, pipe_i8, qwen32, embeds,
                                     bias)
    pipe_i8 = qwen32 = embeds = bias = None
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("Show-o2 understanding [18]", time.perf_counter()))

    # [35b] run_mmu_eval on phase 18's bf16 pipeline
    evaluation["mmu_v2"] = phase_eval_mmu_v2(torch, cuda_build, smi, pipe,
                                             eval_data, eval_tmp.name)
    pipe = None
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("evaluation, Show-o2 [35b]", time.perf_counter()))

    # [18b] Show-o2 video understanding, bf16
    vid = phase_mmu_vid(torch, cuda_build, inference_mmu_vid, und_config,
                        smi)
    parts.append(("Show-o2 video [18b]", time.perf_counter()))

    # [19] / [19b] Show-o2 text/image-to-video (bench.py's t2v rows) through
    # build_t2v_pipeline, the adaLN drawn as in phase 13
    from showo_tpu_torch import inference_lvg, inference_mixed_modality

    pipe = inference_t2i_v2.build_t2v_pipeline(
        load_config(V2_CONFIG), device, guidance_scale=T2V_CFG,
        num_steps=T2V_STEPS, num_latent_frames=T2V_FRAMES["t2v"])
    _draw_adaln(torch, pipe.model, 13)
    t2v_prompts = v2_prompts[:1]
    t2v_results = phase_t2v_kernel(torch, pipe, t2v_prompts, "t2v")
    t2v_counts, t2v_slice = phase_t2v(torch, np, cuda_build, pipe,
                                      t2v_prompts, "t2v", smi)
    t2v_slice["parity"] = phase_t2v_parity(torch, pipe, t2v_prompts, "t2v")
    t2v_slice["i2v"] = phase_i2v(torch, cuda_build, pipe, t2v_prompts, smi)
    parts.append(("t2v [19]", time.perf_counter()))
    pipe = dataclasses.replace(pipe,
                               num_latent_frames=T2V_FRAMES["t2v_long"])
    long_results = phase_t2v_kernel(torch, pipe, t2v_prompts, "t2v_long")
    long_counts, long_slice = phase_t2v(torch, np, cuda_build, pipe,
                                        t2v_prompts, "t2v_long", smi)
    long_slice["parity"] = phase_t2v_parity(torch, pipe, t2v_prompts,
                                            "t2v_long")
    long_slice["vae"] = phase_vae_streaming(torch, pipe, smi)
    pipe = None
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("t2v_long [19b]", time.perf_counter()))

    # [20] mixed modality through inference_mixed_modality.build_pipeline
    pipe = inference_mixed_modality.build_pipeline(load_config(V2_CONFIG, [
        f"guidance_scale={T2V_CFG}",
        f"transport.num_inference_steps={T2V_STEPS}",
        f"max_new_tokens={MIXED_TOKENS}"]), device)
    _draw_adaln(torch, pipe.model, 13)
    phase_mixed(torch, np, cuda_build, profile, pipe, smi)
    pipe = None
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("mixed modality [20]", time.perf_counter()))

    # [21] v1 long video through inference_lvg.build_pipeline
    phase_lvg(torch, np, cuda_build, inference_lvg, inference_t2i, smi)
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("lvg [21]", time.perf_counter()))

    # [22] / [22b] continuous-batching serving: bench.py's serve rows
    # through ShowoMMUServer and Showo2MMUServer
    serve_v1 = phase_serve_v1(torch, np, cuda_build, profile, inference_mmu,
                              smi)
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("serving v1 [22]", time.perf_counter()))
    serve_v2 = phase_serve_v2(torch, np, cuda_build, profile,
                              inference_mmu_v2, smi)
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("serving v2 [22b]", time.perf_counter()))

    # the Show-o2 stage-1 training slice: cuDNN convolutions (the frozen
    # Wan2.1 encoder) on PyTorch's default TF32, as the v1 trainers'
    torch.backends.cudnn.allow_tf32 = True
    # [23] kernels 7 and 8 at head dim 128 vs plain
    v2_train_results = phase_v2_train_kernels(torch)
    # [24] the stage-1 trainer at full width through build_trainer
    trainer = _v2_trainer(torch, "24")
    v2_train = phase_v2_train(torch, cuda_build, profile, trainer, smi)
    # [25] trainable vs dense, one full-width step
    v2_train["slice"]["parity"] = phase_v2_train_parity(torch, trainer)
    # [26] the stage-1 CLI itself: two steps, checkpoints, a resume (phase
    # 24's trainer kept for phase 28's ladder)
    v2_train["slice"]["cli"] = phase_v2_cli(torch, cuda_build)
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("Show-o2 stage-1 training [23-26]", time.perf_counter()))

    # [27] kernel 2's bf16-score variant, and the fused generate under it
    fused_bf16 = phase_fused_bf16(torch, np, inference_t2i, cuda_build, smi)
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("kernel 2 bf16 [27]", time.perf_counter()))

    # [28] the training throughput modes: the remat ladder on phase 24's
    # trainer, then bench.py's four training rows, each through its
    # build_trainer
    rungs = phase_rungs(torch, cuda_build, trainer, smi)
    trainer = None
    gc.collect()
    torch.cuda.empty_cache()
    train_rows = {}
    for name in TRAIN_ROWS:
        train_rows[name] = _train_row(torch, cuda_build, name, smi)
    parts.append(("training modes [28]", time.perf_counter()))

    # [29] Show-o2 mixed-modality training at full width and depth on
    # kernel 8; [30] its CLI's two-phase recipe; [31] the v1 stage-1 CLI
    # with its data loaders, EMA, validation images and resume
    mixed_train = phase_mixed_train(torch, cuda_build, smi)
    gc.collect()
    torch.cuda.empty_cache()
    mixed_train["cli"] = phase_mixed_cli(torch, cuda_build)
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("mixed-modality training [29-30]", time.perf_counter()))
    v1_cli = phase_v1_cli(torch, cuda_build, smi)
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("v1 CLI [31]", time.perf_counter()))

    # [32] Show-o2 stage 2 on LLaVA conversations at full width and depth
    # (kernel 7); [33] the stage-2 and CLIP-ViT CLIs at depth 2; [34] the
    # CLIP-ViT trainer's step at full width and depth (dense)
    stage2 = phase_stage2_train(torch, cuda_build, smi)
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("stage-2 training [32]", time.perf_counter()))
    stage2["cli"] = phase_stage2_cli(torch, cuda_build)
    gc.collect()
    torch.cuda.empty_cache()
    clip_cli = phase_clip_cli(torch, cuda_build)
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("stage-2 and CLIP CLIs [33]", time.perf_counter()))
    clip_train = phase_clip_train(torch, cuda_build, smi)
    clip_train["cli"] = clip_cli
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(("CLIP-ViT training [34]", time.perf_counter()))

    # [35c] the evaluation CLIs, [35d] the VQ PSNR gate
    evaluation["cli"] = phase_eval_cli(np, cuda_build, eval_data,
                                       eval_tmp.name, smi)
    eval_tmp.cleanup()
    parts.append(("evaluation CLIs [35c]", time.perf_counter()))
    evaluation["vq"] = phase_vq_psnr(torch, np, smi)
    parts.append(("VQ PSNR [35d]", time.perf_counter()))
    eval_s = {part: end - begin for (part, end), (_, begin)
              in zip(parts[1:], parts) if "35" in part}
    print(f"[35] the evaluation chain in {sum(eval_s.values()):.1f} s: "
          + ", ".join(f"{p} {s:.1f} s" for p, s in eval_s.items())
          + f"; on {smi}")

    kernels = []
    for route, (name, replaces) in KERNELS.items():
        r512, r256 = results[route]["512"], results[route].get("256")
        entry = {"name": name, "route": "cuda",
                 "source": f"showo_tpu_torch/csrc/{name}.cu" + (
                     " (+ attention_fwd_sm90.cuh)" if route in ROUTE_TILES
                     else ""),
                 "replaces": replaces,
                 "launches": route_launches[route][name],
                 **r512}
        if route == "packed":
            entry["launches_wgmma"] = route_launches[route][PACKED_WGMMA]
            entry["launches_extrapolate"] = extra_launches[name]
            # phase 35a's run_chain, all its generates
            entry["launches_eval"] = evaluation["chain"]["counts"][name]
        # one inpaint (phase 14) on the route
        entry["launches_inpaint"] = mode_launches[route][name]
        if route == "fused":
            entry["part"] = ("the core's launch; 'whole': both launches, "
                             "the pass (fused_decode_norm_rope) and the core")
        if r256 is not None:
            entry.update({f"{key}_256": val for key, val in r256.items()})
        kernels.append(entry)
    # launches of this kernel family in the trainers' CLIs and mixed
    # modality (phases 29-31) beside the stage-1 / 512x512 slices'
    extra_train = {TRAIN_SOURCE: {"launches_v1_cli": v1_cli["counts"],
                                  "launches_stage2_2a": stage2["2a freeze"][
                                      "counts"],
                                  "launches_stage2_unfrozen": stage2[
                                      "frozen_params=[]"]["counts"],
                                  "launches_stage2_cli": stage2["cli"][
                                      "counts"]},
                   STREAM_TRAIN_SOURCE: {
                       "launches_mixed_phase1": mixed_train[
                           "phase-1 freeze"]["counts"],
                       "launches_mixed_unfrozen": mixed_train[
                           "frozen_params=[]"]["counts"],
                       "launches_mixed_cli": mixed_train["cli"]["counts"]}}
    for source, table, counts, res in (
            (TRAIN_SOURCE, TRAIN_KERNELS, train_launches, train_results),
            (STREAM_TRAIN_SOURCE, STREAM_TRAIN_KERNELS, stream_launches,
             stream_results)):
        for name, (replaces, _) in table.items():
            kernels.append({"name": name, "route": "cuda",
                            "source": f"showo_tpu_torch/csrc/{source}.cu",
                            "replaces": replaces, "launches": counts[name],
                            **res[name],
                            **{k: v.get(name, 0) for k, v in
                               extra_train[source].items()}})
    for name, replaces in WSMM_KERNELS.items():
        cases = wsmm[name]
        case = "win M=1"
        kernels.append({"name": name, "route": "cuda",
                        "source": f"showo_tpu_torch/csrc/{name}.cu",
                        "replaces": replaces,
                        "launches": mmu[1]["launches"]
                        if name == "int8_matmul" else 0,
                        # phase 35b's run_mmu_eval over the int8 v1 items
                        "launches_eval": evaluation["mmu"]["counts"].get(
                            name, 0),
                        **cases[case], "case": case, "cases": cases})
    qwen_cases = wsmm["qwen"]
    for name, case, launches in (
            ("int8_matmul_qwen", "qwen gate-up M=1", und[1]["launches"]),
            ("int8_matmul_prefill_qwen", f"qwen gate-up M={V2_PROMPT_ROWS}",
             und[1]["prefill_launches"])):
        kernels.append({"name": name, "route": "cuda",
                        "source": "showo_tpu_torch/csrc/int8_matmul.cu" + (
                            " (+ weight_stream_prefill.cuh)"
                            if "prefill" in name else ""),
                        "replaces": WSMM_KERNELS["int8_matmul"],
                        "launches": launches, **qwen_cases[case],
                        "case": case, "cases": qwen_cases,
                        "slice": {"bf16": und[0], "int8": und[1],
                                  "logits": und_parity, "video": vid}})
    case = f"win M={prefill_rows}"
    for name, source, launches in (
            (PREFILL_KERNEL, "int8_matmul", mmu[1]["prefill_launches"]),
            (INT4_PREFILL_KERNEL, "int4_matmul", 0)):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"showo_tpu_torch/csrc/{source}.cu (+ "
                                  f"weight_stream_prefill.cuh)",
                        "replaces": WSMM_KERNELS[source],
                        "launches": launches,
                        "launches_eval": evaluation["mmu"]["counts"].get(
                            name, 0), **wsmm[name][case],
                        "case": case, "cases": wsmm[name]})
    qwen = V2_SHAPES[0][0]
    for name, source, replaces, which, launches in (
            ("omni_attention_packed_v2", "omni_attention_packed.cu (+ "
             "attention_fwd_sm90.cuh)", KERNELS["packed"][1],
             "packed", v2_launches["omni_attention_packed"]),
            (GQA_SOURCE, f"{GQA_SOURCE}.cu (+ attention_fwd_sm90.cuh)",
             GQA_REPLACES, "stacked", 0)):
        cases = v2_results[which]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"showo_tpu_torch/csrc/{source}",
                        "replaces": replaces, "launches": launches,
                        **cases[qwen], "case": qwen, "cases": cases,
                        **({"slice": v2_slice, "launches_wgmma":
                            v2_launches[PACKED_WGMMA]} if launches else {})})
    for name, route, replaces, launches, extra in (
            ("omni_attention_packed_v2_cached", "packed",
             KERNELS["packed"][1], cached_launches["omni_attention_packed"],
             {"slice": cached_slice,
              "launches_wgmma": cached_launches[PACKED_WGMMA]}),
            ("streaming_attention_v2", "streaming", KERNELS["streaming"][1],
             stream_launches_v2["streaming_attention"],
             {"launches_cached": stream_cached_v2["streaming_attention"],
              "samplers": samplers})):
        cases = cached_results[route]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"showo_tpu_torch/csrc/{KERNELS[route][0]}"
                                  f".cu (+ attention_fwd_sm90.cuh)",
                        "replaces": replaces, "launches": launches,
                        **cases[qwen], "case": f"{qwen}, cached rows",
                        "cases": cases, **extra})
    for route, what in (("omni", "the mask of _attn_kernel, per block"),
                        ("fused", "the mask of _kernel, per block"),
                        ("streaming", "the mask of _stream_kernel, per "
                                      "block"),
                        ("decode", "the bias of _kernel / "
                                   "_kernel_headloop, per block")):
        name = ROUTE_TILES[route]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"showo_tpu_torch/csrc/{KERNELS[route][0]}"
                                  f".cu (+ attention_fwd_sm90.cuh)",
                        "replaces": f"{KERNELS[route][1]} ({what})",
                        "launches": route_launches[route][name],
                        **results[f"{route}_tiles"], "case": "512"})
    kernels.append({"name": FUSED_BF16, "route": "cuda",
                    "source": "showo_tpu_torch/csrc/fused_decode.cu (+ "
                              "attention_fwd_sm90.cuh, BF16S)",
                    "replaces": KERNELS["fused"][1] + " (softmax_dtype="
                                "bfloat16: attn_fp32=False)",
                    "launches": fused_bf16["launches"],
                    **fused_bf16["kernel"], "case": "512",
                    "part": "the core's launch; 'whole': both launches",
                    "slice": fused_bf16["slice"]})
    kernels.append({"name": FUSED_NORM, "route": "cuda",
                    "source": "showo_tpu_torch/csrc/fused_decode.cu",
                    "replaces": KERNELS["fused"][1] + " (the LayerNorm and "
                                "RoPE of _kernel)",
                    "launches": route_launches["fused"][FUSED_NORM],
                    **results["fused_norm"]["512"],
                    **{f"{key}_256": val for key, val in
                       results["fused_norm"]["256"].items()}})
    kernels.append({"name": PACKED_TILES, "route": "cuda",
                    "source": "showo_tpu_torch/csrc/omni_attention_packed.cu "
                              "(+ attention_fwd_sm90.cuh)",
                    "replaces": KERNELS["packed"][1] + " (the mask of "
                                "_attn_kernel_packed, per block)",
                    "launches": route_launches["packed"][PACKED_TILES],
                    **results["tiles"], "case": "512",
                    "launches_v2": v2_launches[PACKED_TILES],
                    "cases": {"512": results["tiles"],
                              "v2": v2_results["tiles"]}})
    for row, res, counts, extra in (
            ("t2v", t2v_results, t2v_counts,
             {"slice": t2v_slice,
              "launches_wgmma": t2v_counts[PACKED_WGMMA]}),
            ("t2v_long", long_results, long_counts, {"slice": long_slice})):
        route = T2V_ROUTES[row]
        name = KERNELS[route][0]
        kernels.append({"name": f"{name}_{row}", "route": "cuda",
                        "source": f"showo_tpu_torch/csrc/{name}.cu (+ "
                                  f"attention_fwd_sm90.cuh)",
                        "replaces": KERNELS[route][1],
                        "launches": counts[name], **res[qwen],
                        "case": f"{qwen}, {row}", "cases": res, **extra})
    # kernel 9 on the serving path: the launches of phase 22's / 22b's timed
    # runs, beside its cases at the engine's rows (phase 9)
    serving = wsmm["serving"]
    for name, case, launches, rows in (
            ("int8_matmul_serving_v1", f"win M={SERVING_ROWS[0]}",
             sum(r["launches"] for r in serve_v1.values()
                 if isinstance(r, dict)), serve_v1),
            ("int8_matmul_serving_v2", f"qwen gate-up M={SERVING_ROWS[1]}",
             serve_v2["launches"], {"serve_v2_spec2_int8": serve_v2})):
        kernels.append({"name": name, "route": "cuda",
                        "source": "showo_tpu_torch/csrc/int8_matmul.cu (+ "
                                  "weight_stream_prefill.cuh)",
                        "replaces": WSMM_KERNELS["int8_matmul"],
                        "launches": launches, **serving[case], "case": case,
                        "cases": serving, "slice": rows})
    # kernels 7 and 8 at head dim 128: phase 23's results, phase 24's
    # launches (the timed steps at 1024 tokens, the step at 2048)
    for source, table, seq in ((TRAIN_SOURCE, TRAIN_KERNELS,
                                V2_TRAIN_SEQ[0]),
                               (STREAM_TRAIN_SOURCE, STREAM_TRAIN_KERNELS,
                                V2_TRAIN_SEQ[1])):
        counts = v2_train["counts"][seq]
        for name in list(table)[:3]:
            kernels.append({"name": name + D128, "route": "cuda",
                            "source": f"showo_tpu_torch/csrc/{source}.cu",
                            "replaces": table[name][0],
                            "launches": counts[name + D128],
                            **v2_train_results[name + D128],
                            "case": f"Qwen2.5 12/2 D=128, S={seq}",
                            **({"slice": v2_train["slice"],
                                "launches_stage2_2a": stage2["2a freeze"][
                                    "counts"][name + D128],
                                "launches_stage2_unfrozen": stage2[
                                    "frozen_params=[]"]["counts"][
                                    name + D128],
                                "launches_stage2_cli": stage2["cli"][
                                    "counts"].get(name + D128, 0),
                                "stage2": stage2, "clip_vit": clip_train}
                               if seq == V2_TRAIN_SEQ[0] else
                               {"mixed_modality": mixed_train}),
                            **({"rungs": rungs, "train_rows": train_rows}
                               if seq == V2_TRAIN_SEQ[0]
                               and name.endswith("_fwd") else {})})
    starts = [t_start] + [t for _, t in parts[:-1]]
    split = ", ".join(f"{part} {end - begin:.1f}"
                      for (part, end), begin in zip(parts, starts))
    print(f"[end] every phase passed in {time.perf_counter() - t_start:.1f} "
          f"s (build included): {split} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
