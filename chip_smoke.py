#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. device: the ``nvidia-smi`` name and power limit; compute capability
   must be (9, 0);
2. build: every kernel of the serving and training paths built by
   ``nvcc`` from the sources in this checkout (one ``nvcc`` per source,
   all at once: six sources), with ``ptxas``'s register and spill lines;
   the SASS (``cuobjdump -sass``) of every instance of the bf16 and fp16
   flash kernels (forward, fused backward, split dQ and dK/dV) and of the
   bf16 and fp16 kernel 9 (each variant: the TMA feed at 64 x 64 and
   128 x 128 tiles, the cp.async feed; each bias dtype) must hold HGMMA
   (tensor-core) instructions, and ptxas must report no spill stores for
   them (``tensor_cores`` lines), nor for any instance of the four f32
   flash kernels, the forward, the fused backward and the split pair
   (each tile width, dropout on and off: ``simt_spills`` lines, with
   their registers), nor for any instance of the paged-decode kernel
   (each page dtype, width, GQA group bound and head dim: ``paged_spills``
   lines, with their registers);
3. paged decode over f32 pages, kernel vs plain version: the kernel
   (``paged_decode_f32``) against its plain PyTorch version on the same
   CUDA tensors, at the serving shape, a GQA shape and a wide batch (64
   sequences), within KERNEL_ATOL; two calls bit-identical, a CUDA graph
   of the call (warmed up on its capture stream) replayed three times
   equal to the eager call bit for bit, the stream's tickets left zero;
4. paged decode, times (calls captured in a CUDA graph, replayed between
   CUDA events after warm-up; inputs rotated through enough copies to
   keep the 50 MB L2 cold, as in a 12-layer decode step): kernel, plain
   version, the bound of the bytes the live K/V rows need, and
   ``scaled_dot_product_attention`` over gathered dense K/V as a library
   yardstick (the port never calls it); each row gives the split walk's
   plan (``n_splits``, ``span_pages``), the achieved GB/s and the share
   of the byte bound;
5. flash attention, kernels vs plain versions: the forward (out and lse)
   and the fused and split backward kernels against the plain forward
   and autograd of the dense plain version on the same CUDA tensors, at
   the BERT-base shape (b 44, h 12, s 512, d 64, a padding bias) and a
   long shape (b 2, h 12, s 2048, d 64, causal and not), with dropout 0
   and 0.1 (the plain side takes ``flash_dropout_mask``'s mask); the
   keep rate within 4 sigma of the binomial, one seed giving the same
   output bit for bit, and a second call of the f32 fused backward and
   split pair giving the same bits;
6. flash attention, times at the two training configurations (padding
   bias, dropout 0.1, not causal; the BERT shape and s=2048): the
   kernels and plain versions by CUDA-graph replay, cold L2; the library
   call between CUDA events, SDPA's forward, and its backward alone (the
   forward run outside the timed region); against the bound
   max(bytes / 3.35 TB/s, flops / 67 TFLOP/s), each row with its
   TFLOP/s and share of the bound, and ``flash_time_split_pair_f32``
   lines the pair's sum and share beside SDPA's backward, and at the
   BERT shape a ``flash_time_fused_vs_pair_f32`` line the fused kernel
   against the pair and SDPA's backward; then s=2048 again without
   dropout (those rows are not the ``kernels`` line's);
7. training: BERT-base (``google-bert/bert-base-uncased`` widths), f32,
   batch 44 x seq 512 with padding, dropout 0.1, ``AdamOptimizer(1e-4)``
   through ``jit_train_step``: 2 warm-up and 10 timed steps on one
   batch; the loss must be finite and fall, and each of the 12 steps
   must launch the forward and the fused backward kernel once per layer;
   then 3 steps of the same widths at seq 2048 (2048 positions, batch 2),
   whose backward must take the split dQ and dK/dV kernels;
8. card vs CPU: 2 layers at full width, batch 2 x seq 128, dropout off,
   the same weights; per-step losses of 3 Adam steps on the card
   (kernels) and on the CPU (plain versions) within rtol 1e-6;

   AMP in bf16 (the example's default), headed a-e:

   a. the bf16 flash kernels (``flash_fwd_bf16``, ``flash_bwd_fused_bf16``,
      ``flash_bwd_dq_bf16``, ``flash_bwd_dkv_bf16``) against their bf16
      plain versions on the card, at the BERT-base shape (b 44, h 12,
      s 512, d 64, padding bias) and the long shape (b 2, h 12, s 2048,
      d 64), causal and not, dropout 0 and 0.1 (the plain side takes
      ``flash_dropout_mask``'s mask): every bf16 output within BF16_ULPS
      bf16 ulps of the largest, lse within KERNEL_ATOL; the keep rate, one
      seed giving the same output bit for bit, and the bf16 kernels apart
      from the f32 kernels on the same inputs by about a bf16 rounding;
   b. their times, as phase 6 (CUDA-graph replay, cold L2; each row also
      gives the achieved TFLOP/s and the share of the bound, and a
      ``flash_time_split_pair_bf16`` line the pair's sum beside SDPA's
      backward and the fused kernel, at both shapes), against the
      plain versions, SDPA in bf16 (forward, and backward alone), and the
      bound max(bytes at 2 bytes an element / 3.35 TB/s, flops / 989
      TFLOP/s, the dense bf16 tensor-core peak); ``fused_occupancy`` lines
      give the fused kernel's CTAs per SM and its waves at the BERT shape;
   c. BERT-base under AMP O1 through ``jit_train_step(amp=True)``: batch
      44 x seq 512 with padding, dropout 0.1, ``AdamOptimizer(1e-4)``, 2
      warm-up and 10 timed steps on one batch; the loss finite and
      falling, each step launching ``flash_fwd_bf16`` and
      ``flash_bwd_fused_bf16`` 12 times and no f32 flash kernel; tokens/s,
      ms/step and ``max_memory_allocated``; then 3 steps at seq 2048
      (batch 2), whose backward launches the split bf16 pair 12 times each;
   d. the bf16 gelu kernels (``gelu_fwd_bf16``, ``gelu_bwd_bf16``, the
      rounding points of JAX's compiled gelu): their tables, built on the
      card, equal to ``gelu_table_reference``'s; the forward on all 65,536
      inputs and the backward on every input with 4 seeded dy bit for bit
      with their plain versions run on the CPU (``gelu_every_input``
      line), and at BERT's FFN shape and a ragged one; timed against
      the byte bound, the plain versions, ``F.gelu`` in bf16 and one
      PyTorch call that moves the same bytes (a copy, an add); then the
      same training under AMP O2 over 2 + 5 steps; every parameter bf16,
      every updated one with an f32 master and f32 moments in the
      optimizer; each step launching each gelu kernel once per layer and
      once for the MLM head (13 times);
   e. the 2-layer model of phase 8 under AMP O1 and O2, 3 Adam steps on
      the card and on the CPU: per-step losses within AMP_LOSS_RTOL, and
      O1's card losses differ from phase 8's f32 ones by more than
      LOSS_RTOL (bf16 did run);

9. serving: ``ServingEngine`` at GPT-2-small widths (12 layers, random
   weights from seed 0) serves 16 requests; every request must finish,
   the kernel's launch count must equal layers x decode steps, and two
   requests must match the full-recompute greedy reference;
10. conv epilogue, kernels vs plain versions, times: ``bn_act_apply_f32``
    (every act, with and without the residual) and ``bn_act_bwd_f32``
    (relu and none, with and without g) against their plain versions at
    the ResNet-50 path's two largest shapes, a ragged shape in both
    layouts and a channels-last (M, C) case: bit for bit for "" and relu
    and the backward, within 1e-6 for sigmoid, tanh and gelu; then each
    kernel held to its plain version (relu, bit for bit) at each of the
    49 shapes one training step gives it, in NCHW and in NHWC, and both
    timed over those 49 calls in the layout phase 11 runs (CUDA-graph
    replay, every call on its own tensors, so the L2 is cold), against
    the byte bound of those calls;
11. ResNet-50 static training: ``examples/train_resnet_static.py``'s
    configuration (vB bottlenecks [3, 4, 6, 3], 224x224, 1000 classes,
    batch 128, Momentum 0.9, weights from the startup program, one batch
    from numpy seed 0) in float32 (``--no-amp``; NCHW, since
    ``FLAGS_cuda_nhwc=auto`` takes channels-last only for bf16
    convolutions), at a tenth of the example's rate
    (``MomentumOptimizer(0.01, 0.9)``; at 0.1 momentum on one repeated
    batch overshoots after two steps and where the twelfth step lands
    varies run to run), through ``fluid`` and ``Executor(CUDAPlace(0))``
    with the fusion flag at auto: 2 warm-up and 10 timed steps; every
    loss finite, the last below the first, each epilogue kernel launched
    exactly 49 times per step, the plan's fused convs in the layout
    phase 10 timed, every scope tensor on the card;
12. ResNet card vs CPU: ResNet-50 at batch 4, 32x32, 100 classes from
    one startup scope on the card and on the CPU: step-1 losses within
    1e-4 relative, later steps finite;
13. matmul epilogue, kernel vs plain version, times: ``matmul_bias_act_f32``
    (kernel 9) with every act at LeNet's two fc shapes, word2vec's hidden
    layer, an all-odd ragged shape and BERT-base's FFN-in shape (gelu)
    against its plain version within the tolerance of JAX's own kernel
    test (rtol 2e-5, atol 2e-4); each timed (CUDA-graph replay, inputs
    rotated through enough copies to keep the L2 cold) against the
    bound max(bytes / 3.35 TB/s, 2MNK / 67 TFLOP/s) and the library
    yardstick ``torch.addmm`` followed by the act (the port never calls
    it), TF32 off; each row names the variant ``f32_variant`` picked (its
    tile and w copy width) and gives the share of the bound, and two calls
    must be bit-identical; the four calls of one LeNet step timed
    together;
14. LeNet static training: ``bench.py:bench_lenet``'s configuration
    (batch 256, 1x28x28, ``MomentumOptimizer(0.01, 0.9)``, program seed
    1, one batch from numpy seed 0) through ``fluid`` and
    ``Executor(CUDAPlace(0))`` with the fusion flag at auto: 5 warm-up and
    30 timed steps; every loss finite, the last below the first, the
    program's two fc+relu chains fused (2 ``fused_matmul_bias_act``, 2
    grads), kernel 9 launched exactly 4 times per step, every scope
    tensor on the card;
15. word2vec static training (vocabulary 2,048, embedding 32, hidden 256,
    batch 256, ``SGDOptimizer(0.1)``, ids from numpy seed 0): the same
    checks with its one fc+sigmoid chain, 2 launches per step;
16. LeNet card vs CPU: ``bench.py:_lenet_losses``'s run (batch 64, lr 0.05,
    12 steps, program seed 5, numpy seed 7) from one startup scope on the
    card and on the CPU: step 1 within 1e-5 relative, every step within
    1e-3 absolute;


   static AMP in bf16 (``fluid.contrib.mixed_precision.decorate``, the
   default of ``examples/train_resnet_static.py``), headed f-k:

   f. conv epilogue bf16: ``bn_act_apply_bf16`` and ``bn_act_bwd_bf16``
      against their plain versions, bit for bit for "" and relu and the
      backward (every act, z, g; ragged shapes in both layouts and an
      (M, C) case; sigmoid, tanh and gelu within a bf16 ulp), then at each
      of the 49 shapes of the AMP ResNet-50 step in NCHW and in NHWC;
      both timed over the 49 calls in the main path's layout (NHWC, from
      ``FLAGS_cuda_nhwc``) against the byte bound (bf16 data) and their
      plain versions;
   g. ResNet-50 under ``decorate(MomentumOptimizer(0.01, 0.9))``, batch
      128, 224x224, channels-last by ``FLAGS_cuda_nhwc=auto``: 2 + 10
      steps, the loss finite and falling, each bf16 epilogue kernel
      launched 49 times a step and no f32 one, the plan's 49 fused convs
      NHWC between its transposes; images/s, ms/step, peak memory;
   h. the AMP ResNet-50 step at the oracle size (batch 4, 32x32) on the
      card (NHWC, kernels) and the CPU (NCHW, plain versions) from one
      startup scope: step 1 within AMP_RESNET_STEP1_RTOL, beside what
      half-ulp bf16 noise on the images does to the CPU's own step 1;
      the state after step 1, velocities and the rest apart, within
      twice that noisy twin's worst and median per-tensor error;
   i. matmul epilogue bf16: ``matmul_bias_act_bf16`` (tensor cores) at
      the tile edges (MATMUL_LOW_EDGES: every variant that takes the shape
      with gelu and both bias dtypes, the variant ``tc_variant`` picks
      with every act; ``matmul_edge_bf16`` lines) and at phase 13's shapes
      with every act against its plain version (the AMP program's unfused
      chain): every output within one bf16 rounding of its product, a bf16
      bias once; timed against the bound (2MNK / 989 TFLOP/s, bf16 operand
      bytes), the plain version and ``torch.addmm`` in bf16 plus the act,
      with TFLOP/s and the share of the bound; FFN-in a second time with a
      bf16 bias (a bf16 output, the bytes ``addmm`` writes); the four
      calls of one LeNet step together;
   j. LeNet and word2vec under ``decorate`` at phase 14-15's
      configurations: the bf16 kernel 9 launched 4 and 2 times a step and
      the f32 one never;
   k. AMP LeNet card vs CPU, 12 steps from one startup scope: step 1
      within AMP_LENET_STEP1_RTOL, every step within AMP_LENET_LOSS_ATOL;

   quantized KV serving (bf16 and int8 pools), headed l-o:

   l. the paged-decode kernels over bf16 and int8 pages
      (``paged_decode_bf16``, ``paged_decode_int8``) against their plain
      versions on the same CUDA tensors at the serving and GQA shapes of
      phase 3 (within KERNEL_ATOL: both dequantize as
      ``code * (scale / 127)``), checked and timed as phases 3-4 (SDPA in
      bf16 over gathered bf16 K/V; for int8, which no PyTorch call takes,
      over K/V dequantized to f32 beforehand);
   m. serving: phase 9's engine and trace with bf16 and with int8 pools
      bought by phase 9's byte budget (1,152 MiB: 2,048 and 4,096
      pages); each launches its own kernel layers x decode steps times
      and no other decode kernel; pages, pool bytes, tokens/s, decode
      ms/step, prefill ms/request, preemptions, peak memory, and the
      share of generated tokens equal to phase 9's f32 run;
   n. the prefix cache and chunked prefill at GPT-2-small widths: 8
      requests sharing a 256-token prefix (suffixes of 32-128 tokens, 32
      new tokens each) served cold, with the prefix cache (its hit
      tokens must be > 0) and with 64-token chunks, for each dtype; the
      tokens equal the cold run's, or part from them first where the f32
      reference's top-2 logit margin is below TIE_FACTOR times the
      dtype's logit error, measured here against the reference over a
      probe request and printed beside it;
   o. 2 layers at GPT-2-small width on the card and on the CPU, bf16 and
      int8 pools, once with the prefix cache (forks included) and once
      with 32-token chunks: equal event streams under phase n's rule,
      int8 codes within 1, layer 0's scales within SCALE_RTOL and the
      deeper layers' within SCALE_RTOL_DEEP;

9b. serving completeness (after phase o; phase 9's GPT-2-small engine
    and trace, the compiled step on): phase 9's 16 requests sampled
    (``SAMPLED``: temperature 0.8, top-k 50, top-p 0.95) by two fresh
    engines and once eagerly, all bit-identical, kernel 6 launched layers
    x decode steps, ``top_k=1`` sampling equal to phase 9's greedy
    streams, decode ms/step sampled beside greedy (``serving_sampled``);
    ``StaticBatchingEngine(core, 8)`` against the continuous engine,
    tokens equal up to a near-tie, both tokens/s (``serving_static``);
    greedy speculative decoding (``SPEC_K`` 4, the n-gram proposer) over
    16 self-similar prompts (``poisson_trace(repeat_frac=0.5)``) on f32
    pools and int8 pools of phase 9's byte budget, each stream equal to
    the same engine's plain one or parting first where the f32
    reference's top-2 margin is below TIE_MARGIN (f32) or phase n's
    quantized tie (int8: a page keeps the scale its rejected drafts
    raised); proposed and accepted counts, verify calls against plain
    decode steps, verify ms per call, tokens/s with spec on and off
    (``serving_spec``); the overload bench's quick trace on the card,
    ``slo_aware`` goodput strictly above fifo's and no request hung
    (``serving_overload``); telemetry and request tracing on against off
    in turns: the same streams, spans and counters reconciled with the
    engine's stats, the wall overhead (``serving_telemetry``);

   static AMP in fp16 with dynamic loss scaling
   (``decorate(use_fp16=True)``, the reference's AMP), headed p-u:

   p. conv epilogue fp16: phase f for ``bn_act_apply_fp16`` and
      ``bn_act_bwd_fp16`` (errors in fp16 half-ulps, 2^-11 of the largest
      output), timed over the 49 calls of the fp16 program in its layout;
   q. matmul epilogue fp16: phase i for ``matmul_bias_act_fp16`` (one
      fp16 rounding of each product, 2^-10 |x @ w|, where bf16 has one
      bf16 rounding), timed against the bound, the plain version and
      ``torch.addmm`` in fp16 plus the act;
   r. ResNet-50 under ``decorate(MomentumOptimizer(0.01, 0.9),
      use_fp16=True)`` with decorate's defaults (scale 2^15), batch 128,
      224x224, channels-last: 2 + 10 steps, run on until
      FP16_CLEAN_STEPS steps found no Inf (at most FP16_MAX_STEPS); the
      loss finite and falling over the clean steps, each fp16 epilogue
      kernel launched 49 times a step and no f32 or bf16 one; images/s,
      ms/step, peak memory, the found-Inf steps and the scale after each
      step, and a profile of two more steps (idle share, kernels and ops
      per step);
   s. the fp16 ResNet-50 step at the oracle size on the card and the CPU:
      with decorate's defaults (every step finds an Inf), the found-Inf
      flags and the scale after each of 3 steps equal and step 1's loss
      within twice what half an fp16 rounding step of image noise does to
      the CPU's own (two noisy twins); then from FP16_CLEAN_SCALE, where
      no step finds one, the same and the state after step 1 within twice
      the first twin's envelope;
   t. LeNet and word2vec under ``decorate(use_fp16=True)`` at phases
      14-15's configurations: the fp16 kernel 9 launched 4 and 2 times a
      step and no other kernel 9, no step finding an Inf;
   u. fp16 AMP LeNet card vs CPU, 12 steps: phase k's tolerances and the
      found-Inf and scale history equal;

   dygraph AMP in fp16 (``jit_train_step(amp_dtype="float16")``, no loss
   scale, as in the JAX package), headed v-z:

   v. phases a-b for the fp16 flash kernels (``flash_fwd_fp16``,
      ``flash_bwd_fused_fp16``, ``flash_bwd_dq_fp16``,
      ``flash_bwd_dkv_fp16``): every fp16 output within FP16_ULPS fp16
      ulps (2^-10) of the largest, the keep rate, one seed giving the
      same output bit for bit, the fp16 kernels apart from the f32 ones by
      about an fp16 rounding; times against the plain versions, SDPA in
      fp16 and the bound (989 TFLOP/s, the dense fp16 tensor-core peak);
   w. phase c under ``amp_dtype="float16"``: BERT-base AMP O1, 2 + 10
      steps at batch 44 x seq 512, each launching ``flash_fwd_fp16`` and
      ``flash_bwd_fused_fp16`` 12 times and no f32 or bf16 flash kernel,
      then 3 steps at seq 2048 (the split fp16 pair);
   x. the fp16 gelu kernels (``gelu_fwd_fp16``, ``gelu_bwd_fp16``) as
      phase d, then BERT-base AMP O2 in fp16 over 2 + 5 steps: every
      parameter fp16 with an f32 master, the fp16 gelu kernels 13 times a
      step;
   y. phase e in fp16: the 2-layer model, 3 Adam steps at O1 and O2 on the
      card and on the CPU within AMP_LOSS_RTOL, at batch 1 x seq 64 (a
      host CPU without fp16 arithmetic runs fp16 GEMMs slowly), with an
      f32 card run of that batch for the check that fp16 did run;
   z. head dims that are no tile width: the flash kernels at d 96 in
      f32, bf16 and fp16 (and at d 40 and 120 in f32), and the paged
      decode kernels over f32, bf16 and int8 pages at d 40, 96, 120 and
      160, against their plain versions;

   Every phase above runs its steps op by op
   (``FLAGS_cuda_step_session=0``), as they count kernel launches per
   step and a replayed CUDA graph calls no wrapper (phase 16a's profiles
   and NHWC turns turn the session on for their timed turns);

16a. MobileNetV3-large static training on the PaddleClas recipe
    (``tools/train_mobilenet.py``: batch 128, 224x224, 1000 classes,
    Momentum 0.9, ``L2Decay(2e-5)``, a linear warm-up into a cosine, the
    rate computed in the program), op by op: in f32 (NCHW), under
    ``decorate`` in bf16 and in fp16 (NHWC by auto; fp16 run on until
    FP16_CLEAN_STEPS are clean), 2 + MOBILENET_STEPS steps each; every
    loss finite and the last below the first (clean steps), kernels 7, 8
    and 9 of the dtype launched MOBILENET_PER_STEP times a step (12, 12,
    16: a fused fc launches kernel 9 for its forward and its grad's
    replay) and no other one, the plan's 12 fused convs (6 depthwise) and
    8 fused fcs; ms/step, images/s, peak memory, casts and transposes a
    step, a 1-step profile (busy ms, idle share, the convolutions', the
    epilogue kernels', the BN reductions' and the copies' device ms, and
    each op type's, the plain BatchNorms' among them) with the compiled
    step off and on in turns (``mobilenet_training_*`` lines); the bf16
    step captured with NHWC 0 and 1 in turns
    (``mobilenet_nhwc_turns_bf16``); 5 bf16 steps at full size eager and
    captured, bit for bit, fetches (the rate, new at every step) and
    state (its counter) (``mobilenet_step_capture``); MobileNetV3-small
    f32 at batch 4, 32x32 on the card and the CPU port from one startup
    scope, step 1 within MOBILENET_STEP1_RTOL (``mobilenet_card_vs_cpu``);

16b. the compiled step (``FLAGS_cuda_step_session`` at auto: a static
    step or a decode step captured in a CUDA graph; the checks are
    ``paddle_tpu_torch/tools/check_step_capture.py``'s): 4 steps of
    ResNet-18 (batch 4, 32x32) in f32, bf16 and fp16 (a step finds an
    Inf), LeNet, word2vec and MobileNetV3-small under bf16 ``decorate``
    (batch 4, 32x32, its rate new at every step), eager and captured from
    one startup state,
    bit for bit (every fetch, every scope tensor after), one graph each;
    decode over f32, bf16 and int8 pools at GPT-2 small's widths (4
    layers, 8 requests, 12 new tokens) eager and captured: the same token
    streams, pools and scales, graphs at most the buckets; a
    ``scope.set`` drops the graph and the step after the next captures
    again, a new batch size adds a graph; a dropout program draws a new
    mask on every replay, equal to the eager step's; a fixed-seed random
    op raises ``StepCaptureError`` (``step_capture_check`` lines); then
    wall and busy ms per step and the idle share with the session off
    and on, in turns (off, on, on, off), of AMP ResNet-50 bf16 at batch
    128, LeNet f32 and AMP bf16 and word2vec at batch 256, and the decode
    step at batch 8 of phase 9's engine in each KV dtype
    (``step_capture_time`` lines, each with its graph count); every
    kernel of these paths launched in the phase
    (``step_capture_launches``);

17. the ``kernels`` line, one row per TPU kernel of
    ``paddle_tpu/ops/pallas_kernels.py`` and dtype: the nine f32 rows
    (``flash_fwd_f32`` replaces two; kernel 6 at the serving shape), the
    two quantized rows of kernel 6 (launches from phase m), the five
    bf16 rows of kernels 1-5 (the bf16 launches from phase c, the AMP O1
    main path), the three bf16 rows of kernels 7-9 (launches from phases
    g and j), the three fp16 rows of kernels 7-9 (launches from phases r
    and t), the four fp16 rows of kernels 1-5 (launches from phase w, the
    fp16 O1 main path), and the two bf16 and two fp16 gelu kernels of the
    AMP O2 paths (launches from phases d and x; no Pallas kernel: their
    rows name the JAX lowering XLA fuses), the card's name and power
    limit, and the last line:
    ``{"ok": true, "device": {...}}``.

Each phase's heading carries the seconds since the start.  The port is
imported only after the device check, so run without the rest of the
repository, or without a CUDA device, it fails.
"""
import gc
import json
import os
import re
import subprocess
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and
# float32 outside the tensor cores (the kernel's arithmetic)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# f32 kernel vs plain version: the same sums in another order
KERNEL_ATOL = 1e-4
# flash gradients: sums of up to 2048 f32 terms in another order than
# autograd's, so relative to the gradient's size
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
# the whole model on the card (kernels) vs on the CPU (plain versions):
# per-step losses of f32 runs that differ in every summation order
# (measured 1.0e-7 on the H100; 1e-6 keeps a 10x margin and sits
# below what bf16 changes, so phase e can tell the two apart)
LOSS_RTOL = 1e-6
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet): the least time
# the card could take for the bf16 kernels' products; dense fp16 has the
# same peak
BF16_FLOP_PER_S = 989e12
# bf16 flash kernels vs their bf16 plain versions: both round p, pd and dS
# to bf16 at the same points; the forward kernel rounds p against the
# running max of its kv tile (the plain version against the row's final
# max) and every sum runs in another order, so an output may land a
# rounding step or two apart: every bf16 output within BF16_ULPS bf16
# ulps (2^-8 relative) of the tensor's largest magnitude (measured: at
# most 0.95 here on the H100, 1.5 for the plain versions against JAX's
# kernels in interpret mode on the CPU)
BF16_ULPS = 4
# fp16 flash kernels vs their fp16 plain versions: the same rounding
# points, in fp16 ulps (2^-10 relative) of the tensor's largest magnitude
FP16_ULPS = 4
# per dygraph AMP dtype: the flash kernels' name tag, an ulp relative to
# 1, and the limit in those ulps
FLASH_LOW = {"bfloat16": ("bf16", 2.0 ** -8, BF16_ULPS),
             "float16": ("fp16", 2.0 ** -10, FP16_ULPS)}
# AMP (bf16) losses on the card (kernels, cuBLAS bf16 GEMMs) vs on the CPU
# (plain versions, oneDNN bf16 GEMMs), per step of 3 Adam steps: bf16
# roundings in two summation orders; JAX and the port differ by up to
# 2.3e-5 at this size on the CPU (2 layers, full width), 10x margin
AMP_LOSS_RTOL = 3e-4
# the ResNet-50 step-1 loss on the card vs on the CPU (cuDNN vs oneDNN
# convolutions, each f32; __graft_entry__.py:199-203)
RESNET_STEP1_RTOL = 1e-4
# ResNet-50's learning rate on its one repeated batch: the example's 0.1
# with momentum 0.9 overshoots after two steps and swings back over about
# ten, so whether step 12 ends below step 1 varies run to run; at 0.01 the
# loss falls from 7.13 to about 4.8 in every run, near the entropy of the
# batch's label counts (the net has learnt which labels occur)
RESNET_LR = 0.01
# bn_act kernels with sigmoid / tanh / gelu vs the plain versions (the
# same formula through libdevice and through PyTorch's kernels)
EPILOGUE_TOL = 1e-6
# kernel 9 vs its plain version: JAX's own kernel test's tolerance
# (tests/test_fused_epilogue.py:116-117), f32 sums in another order
MATMUL_RTOL, MATMUL_ATOL = 2e-5, 2e-4
# LeNet on the card vs on the CPU from one startup scope: step 1, and
# every step of bench.py:_lenet_losses's 12 (both sides f32)
LENET_STEP1_RTOL, LENET_LOSS_ATOL = 1e-5, 1e-3
# the bf16 / fp16 flash kernels, all on the tensor cores: each entry
# point's kernel template, its element type as they appear in the mangled
# names, and its tile widths (one instance each; the fused kernel runs
# head dims up to 64 at the 64 tile)
TC_KERNELS = {
    f"flash_{entry}_{tag}": (f"flash_{kernel}_tc_kernel", elem, widths)
    for entry, kernel, widths in (("fwd", "fwd", (32, 64, 128)),
                                  ("bwd_fused", "bwd_fused", (64, 128)),
                                  ("bwd_dq", "bwd_dq", (32, 64, 128)),
                                  ("bwd_dkv", "bwd_dkv", (32, 64, 128)))
    for tag, elem in (("bf16", "13__nv_bfloat16"), ("fp16", "6__half"))}
# the L2 a timing's rotated inputs must overflow to run cold (50 MB)
COLD_BYTES = 64 << 20
# a served token may differ from the reference only where the
# reference's top-2 logit margin is below this (f32 rounding of two
# different compositions of the same model)
TIE_MARGIN = 1e-3


T0 = time.perf_counter()


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def phase(name: str):
    print(f"== {name} (t={time.perf_counter() - T0:.1f} s)", flush=True)


def time_ms(fn, args_sets, per_graph=40, replays=10) -> float:
    """Mean device milliseconds per call of ``fn(*args)``, cycling
    through ``args_sets``.  The calls are captured into one CUDA graph
    and replayed between two CUDA events, so the wrappers' host work
    (argument checks, the ctypes call) is not in the time."""
    import torch

    # warm-up on the capture stream: library loaded, allocator primed, and
    # the paged kernels' per-stream tickets made outside the capture
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for args in args_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(per_graph):
            fn(*args_sets[i % len(args_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def make_decode_case(rng, hq, hkv, d, ps, n_pages, ctx_lens, n_pad=0):
    """One decode-attention input set on the card: q, pools, tables with
    each sequence's pages drawn without replacement from the whole pool
    (so no sequence's pages are contiguous), lengths; ``n_pad`` extra
    rows are bucket padding (context 1, table of page 0)."""
    import torch

    ctx = np.asarray(list(ctx_lens) + [1] * n_pad, np.int32)
    b = len(ctx)
    need = [-(-int(c) // ps) for c in ctx_lens]
    width = 1
    while width < max(need):
        width *= 2
    perm = rng.permutation(n_pages)
    tables = np.zeros((b, width), np.int32)
    off = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[off:off + n]
        off += n
    dev = "cuda"
    q = torch.from_numpy(rng.randn(b, hq, d).astype(np.float32)).to(dev)
    k = torch.randn(hkv, n_pages, ps, d, device=dev)
    v = torch.randn(hkv, n_pages, ps, d, device=dev)
    return (q, k, v, torch.from_numpy(tables).to(dev),
            torch.from_numpy(ctx).to(dev))


def sdpa_inputs(case):
    """The library yardstick's inputs: each sequence's K/V gathered dense
    through its table, heads repeated for GQA, and a boolean mask of the
    live positions."""
    import torch

    q, k, v, tables, ctx = case
    b, hq, d = q.shape
    hkv, _, ps, _ = k.shape
    g = hq // hkv
    flat = tables.reshape(-1).long()
    kd = k.index_select(1, flat).reshape(hkv, b, -1, d).transpose(0, 1)
    vd = v.index_select(1, flat).reshape(hkv, b, -1, d).transpose(0, 1)
    kd = kd.repeat_interleave(g, dim=1).contiguous()
    vd = vd.repeat_interleave(g, dim=1).contiguous()
    pos = torch.arange(kd.shape[2], device=q.device)
    mask = (pos[None, :] < ctx[:, None])[:, None, None, :]
    return q[:, :, None, :].contiguous(), kd, vd, mask


def make_paged_case(rng, dtype, hq, hkv, d, ps, n_pages, ctx_lens,
                    n_pad=0):
    """``(case, scales)``: ``make_decode_case``'s f32 pools, or its
    tables and lengths over bf16 pools, or int8 pools (codes in [-127,
    127]) with their f32 scale pools."""
    import torch

    q, k, v, tables, ctx = make_decode_case(rng, hq, hkv, d, ps, n_pages,
                                            ctx_lens, n_pad)
    if dtype == "float32":
        return (q, k, v, tables, ctx), ()
    if dtype == "bfloat16":
        return (q, k.bfloat16(), v.bfloat16(), tables, ctx), ()
    del k, v
    codes = [torch.randint(-127, 128, (hkv, n_pages, ps, d), device="cuda",
                           dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand(hkv, n_pages, device="cuda") * 2 + 0.1
              for _ in range(2)]
    return (q, *codes, tables, ctx), tuple(scales)


def paged_bytes(case, scales):
    """The bytes a call must move: the live K/V rows at the pool's element
    size, the live pages' scales (int8), q, out, tables and lengths."""
    q, k, _, tables, ctx = case
    hkv, _, ps, d = k.shape
    tokens = int(ctx.sum())
    nbytes = (2 * tokens * hkv * d * k.element_size() + 2 * q.numel() * 4
              + tables.numel() * 4 + ctx.numel() * 4)
    if scales:
        nbytes += 2 * hkv * 4 * int(((ctx + ps - 1) // ps).sum())
    return nbytes


def paged_bound(case, scales):
    """(bound_ms, bound_by): :func:`paged_bytes` over HBM bandwidth,
    against the f32 operations over the f32 peak."""
    q, k, _, _, ctx = case
    hq, d = q.shape[1], q.shape[2]
    tokens = int(ctx.sum())
    t_bytes = paged_bytes(case, scales) / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * d * hq * tokens / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_library_inputs(case, scales, dtype):
    """SDPA's inputs: K and V gathered dense in the pool's dtype (q cast
    to it) for f32 and bf16 pools; for int8 (no PyTorch call takes int8
    pages and scales) the K/V dequantized to f32 beforehand, f32 q."""
    import torch

    q, k, v, tables, ctx = case
    if scales:
        flat = tables.reshape(-1).long()
        k = torch.zeros(k.shape, device="cuda").index_copy_(
            1, flat, k.index_select(1, flat).float()
            * (scales[0].index_select(1, flat) / 127.0)[..., None, None])
        v = torch.zeros(v.shape, device="cuda").index_copy_(
            1, flat, v.index_select(1, flat).float()
            * (scales[1].index_select(1, flat) / 127.0)[..., None, None])
    qd, kd, vd, mask = sdpa_inputs((q, k, v, tables, ctx))
    if dtype == "bfloat16":
        qd = qd.bfloat16()
    return qd, kd, vd, mask


#: per pool dtype: the element size, the wrapper's name, the library row
PAGED_DTYPES = {
    "float32": (4, "paged_decode", "sdpa_f32_dense"),
    "bfloat16": (2, "paged_decode_bf16", "sdpa_bf16_dense"),
    "int8": (1, "paged_decode_int8", "sdpa_f32_dense_predequantized")}


def tickets_zero(pa, q, stream):
    """Whether the split walk left ``stream``'s tickets on q's device zero
    (or made none: a walk of one split takes none)."""
    t = pa._TICKETS.get((q.device.index, stream.cuda_stream))
    return t is None or not bool(t.any())


def check_and_time_paged(name, dtype, rng, hq, hkv, d, ps, n_pages,
                         ctx_lens, n_pad=0):
    """The paged-decode kernel over one pool dtype at one shape: against
    its plain version on the same CUDA tensors (only the order of the sums
    differs; both dequantize int8 as ``code * (scale / 127)``:
    KERNEL_ATOL); two calls and a CUDA graph's replays equal bit for bit,
    the tickets left zero; then timed by CUDA-graph replay over enough
    input sets to keep the L2 cold."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import paged_attention as pa

    esize, wrapper, library = PAGED_DTYPES[dtype]
    live = 2 * sum(ctx_lens) * hkv * d * esize
    n_sets = max(4, -(-COLD_BYTES // live) + 1)
    cases = [make_paged_case(rng, dtype, hq, hkv, d, ps, n_pages, ctx_lens,
                             n_pad) for _ in range(n_sets)]
    scale = d ** -0.5
    kernel = getattr(pa, wrapper)
    err = 0.0
    for c, sc in cases[:4]:
        got = kernel(*c, scale, *sc)
        want = pa.paged_attention_reference(*c, scale, *sc)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"{dtype} {name}: kernel output not finite")
        err = max(err, float((got - want).abs().max()))
    if err > KERNEL_ATOL:
        fail(f"{dtype} {name}: kernel vs plain max |err| {err:.3e} > "
             f"{KERNEL_ATOL}")
    # the split walk's merge: two calls and a CUDA graph's replays (the
    # call warmed up on its capture stream) equal bit for bit, the
    # tickets left zero
    c, sc = cases[0]
    eager = kernel(*c, scale, *sc)
    if not torch.equal(eager, kernel(*c, scale, *sc)):
        fail(f"{dtype} {name}: two calls differ")
    torch.cuda.synchronize()
    if not tickets_zero(pa, c[0], torch.cuda.current_stream()):
        fail(f"{dtype} {name}: the tickets are not left zero")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel(*c, scale, *sc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = kernel(*c, scale, *sc)
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(captured, eager):
            fail(f"{dtype} {name}: a CUDA graph replay differs from the "
                 f"eager call")
    if not tickets_zero(pa, c[0], side):
        fail(f"{dtype} {name}: the replays left the tickets non-zero")
    del graph, captured, eager
    n_splits, span = pa.split_plan(c[0], c[1], c[3])
    args = [(*c, *sc) for c, sc in cases]
    ms = time_ms(lambda *a: kernel(*a[:5], scale, *a[5:]), args)
    plain_ms = time_ms(lambda *a: pa.paged_attention_reference(
        *a[:5], scale, *a[5:]), args)
    lib_sets = [paged_library_inputs(c, sc, dtype) for c, sc in cases[:4]]
    lib_ms = time_ms(lambda q, kd, vd, m: F.scaled_dot_product_attention(
        q, kd, vd, attn_mask=m, scale=scale), lib_sets)
    bound_ms, bound_by = paged_bound(*cases[0])
    row = {"shape": name, "dtype": dtype, "B": len(cases[0][0][4]), "Hq": hq,
           "Hkv": hkv, "D": d, "page_size": ps,
           "width": int(cases[0][0][3].shape[1]), "input_sets": n_sets,
           "ctx": [int(x) for x in cases[0][0][4].tolist()],
           "max_abs_err": err, "tolerance": KERNEL_ATOL,
           "n_splits": n_splits, "span_pages": span,
           "repeatable": True, "graph_replay_equal": True,
           "tickets_zero": True, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "gb_per_s": paged_bytes(*cases[0]) / ms / 1e6,
           "bound_share": bound_ms / ms, "library_ms": lib_ms,
           "library": library}
    print("kernel_case " + json.dumps(row), flush=True)
    del cases, args, lib_sets
    torch.cuda.empty_cache()
    return row


PAGED_SHAPES = (  # (name, q heads, kv heads, head dim, pages, contexts, pad)
    # the serving shape: GPT-2 small heads, 6 live sequences with ragged
    # lengths (page boundaries among them) and 2 bucket-padding rows
    ("serving", 12, 12, 64, 1024, (1024, 777, 512, 301, 64, 17), 2),
    ("gqa", 32, 8, 128, 1024, (1, 16, 33, 250, 512, 700, 1000, 1024), 0),
)


def wide_batch_lens():
    """64 contexts of 1-1,024 tokens: at the serving heads the planner
    doubles the span to 32 pages (2 splits of a 64-page table)."""
    lens = np.random.RandomState(3).randint(1, 1025, 64).tolist()
    lens[:3] = [1024, 512, 513]
    return lens


def paged_kernel_phase(dtype):
    """The kernel over ``dtype`` pages at the serving and GQA shapes (and,
    over f32 pages, the wide batch): the serving row for the ``kernels``
    line, with the largest error of them all."""
    rng = np.random.RandomState(0)
    shapes = list(PAGED_SHAPES)
    if dtype == "float32":
        shapes.append(("wide", 12, 12, 64, 4200, wide_batch_lens(), 0))
    rows = [check_and_time_paged(name, dtype, rng, hq, hkv, d, 16, n_pages,
                                 lens, n_pad)
            for name, hq, hkv, d, n_pages, lens, n_pad in shapes]
    return {**rows[0], "max_abs_err": max(r["max_abs_err"] for r in rows)}


#: GPT-2 small widths (openai-community/gpt2 config.json)
GPT2_SMALL = dict(vocab_size=50257, hidden=768, num_heads=12, num_layers=12,
                  max_seq_len=1024)
#: the quantized serving runs' KV budget: the f32 run's 1,024 pages of
#: 1,179,648 bytes (2 x 12 layers x 12 heads x 16 slots x 64 x 4 bytes)
KV_BUDGET_MB = 1152


def decode_kernels():
    from paddle_tpu_torch.ops import paged_attention as pa
    return {"float32": pa.PAGED_DECODE, "bfloat16": pa.PAGED_DECODE_BF16,
            "int8": pa.PAGED_DECODE_INT8}


def serve(torch, kv_dtype="float32"):
    """``serve()``'s 16-request trace through the GPT-2-small engine: f32
    pools of 1,024 pages, or bf16 / int8 pools bought by the same byte
    budget.  Returns the decode kernel's launches, the report and every
    request's tokens."""
    from paddle_tpu_torch.inference.serving import (
        DecoderConfig, Request, ServingEngine, init_decoder_weights)

    cfg = DecoderConfig(**GPT2_SMALL)
    pool = dict(num_pages=1024) if kv_dtype == "float32" else \
        dict(kv_budget_mb=KV_BUDGET_MB)
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, init_decoder_weights(cfg, 0), page_size=16,
                        max_batch=8, token_budget=1024, device="cuda",
                        kv_dtype=kv_dtype, **pool)
    print(f"engine set-up {time.perf_counter() - t0:.3f} s "
          f"(weights {sum(p.numel() for p in eng.core.model.parameters())} "
          f"f32, {kv_dtype} KV pools of "
          f"{eng.core.kv_config.num_pages} pages, "
          f"{eng.core.kv_pool_resident_bytes()} B)", flush=True)
    core = eng.core
    # warm-up request (cuBLAS handles, allocator), not counted
    eng.generate([list(range(1, 33))], max_new_tokens=4)

    rng = np.random.RandomState(0)
    lens = rng.randint(32, 513, size=16)
    reqs = [Request(i, rng.randint(0, cfg.vocab_size, size=int(n)).tolist(),
                    max_new_tokens=64) for i, n in enumerate(lens)]
    wall = {"prefill": 0.0, "decode": 0.0}
    prefill_fn, decode_fn = core.prefill, core.decode_batch

    def timed(fn, key):
        def run(*a):
            t = time.perf_counter()
            out = fn(*a)        # ends in a host read of the tokens
            wall[key] += time.perf_counter() - t
            return out
        return run

    core.prefill = timed(prefill_fn, "prefill")
    core.decode_batch = timed(decode_fn, "decode")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps0 = eng.stats["decode_steps"]
    kernels = decode_kernels()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = {dt: k.launches for dt, k in kernels.items()}
    launches = counts[kv_dtype]
    del core.prefill, core.decode_batch   # the class's methods again
    peak = torch.cuda.max_memory_allocated()

    done = [r for r in reqs if r.finished_at is not None
            and len(r.out_tokens) == r.max_new_tokens]
    if len(done) != len(reqs):
        fail(f"{len(reqs) - len(done)} of {len(reqs)} requests unfinished")
    steps = eng.stats["decode_steps"] - steps0
    if launches != cfg.num_layers * steps:
        fail(f"{kernels[kv_dtype].name} launches {launches} != layers "
             f"{cfg.num_layers} x decode steps {steps}")
    if any(n for dt, n in counts.items() if dt != kv_dtype):
        fail(f"a {kv_dtype} engine launched another pool dtype's decode "
             f"kernel: {counts}")
    n_tok = sum(len(r.out_tokens) for r in reqs)
    report = {"kv_dtype": kv_dtype, "pages": core.kv_config.num_pages,
              "kv_pool_resident_bytes": core.kv_pool_resident_bytes(),
              "requests": len(reqs), "prompt_tokens": int(lens.sum()),
              "generated_tokens": n_tok, "wall_s": elapsed,
              "tokens_per_s": n_tok / elapsed,
              "decode_steps": steps,
              "decode_ms_per_step": wall["decode"] / steps * 1e3,
              "prefill_ms_total": wall["prefill"] * 1e3,
              "prefill_ms_per_request": wall["prefill"] / len(reqs) * 1e3,
              "preempted": eng.stats["preempted"],
              "max_memory_allocated": peak,
              f"{kernels[kv_dtype].name}_launches": launches}

    if kv_dtype == "float32":
        # two requests against the full-recompute greedy reference
        checked = []
        for r in (min(reqs, key=lambda r: len(r.prompt)),
                  max(reqs, key=lambda r: len(r.prompt))):
            ref = core.greedy_reference(r.prompt, r.max_new_tokens)
            row = {"req": r.req_id, "prompt": len(r.prompt),
                   "identical": ref == r.out_tokens}
            if ref != r.out_tokens:
                i = next(j for j, (a, b) in enumerate(zip(ref, r.out_tokens))
                         if a != b)
                top2 = torch.topk(core.reference_logits(
                    r.prompt + r.out_tokens[:i]), 2).values
                margin = float(top2[0] - top2[1])
                row.update(first_divergence=i, top2_margin=margin)
                if margin >= TIE_MARGIN:
                    fail(f"request {r.req_id} diverges from the reference "
                         f"at token {i} with top-2 margin {margin:.3e} >= "
                         f"{TIE_MARGIN}")
            checked.append(row)
        report["reference_check"] = checked
        report["tie_margin_tolerance"] = TIE_MARGIN
    print("serving " + json.dumps(report), flush=True)
    del eng, core
    gc.collect()
    torch.cuda.empty_cache()
    return launches, report, [r.out_tokens for r in reqs]


# ==========================================================================
# flash attention: kernels vs plain versions, times
# ==========================================================================
FLASH_ROWS = (  # (kernel name, TPU kernel it replaces)
    ("flash_fwd_f32", "paddle_tpu/ops/pallas_kernels.py:203"),
    # the multi-block forward: the same kernel takes both
    ("flash_fwd_f32", "paddle_tpu/ops/pallas_kernels.py:150"),
    ("flash_bwd_fused_f32", "paddle_tpu/ops/pallas_kernels.py:449"),
    ("flash_bwd_dq_f32", "paddle_tpu/ops/pallas_kernels.py:386"),
    ("flash_bwd_dkv_f32", "paddle_tpu/ops/pallas_kernels.py:413"),
)
FLASH_BF16_ROWS = tuple((name.replace("_f32", "_bf16"), replaces)
                        for name, replaces in FLASH_ROWS)
FLASH_FP16_ROWS = tuple((name.replace("_f32", "_fp16"), replaces)
                        for name, replaces in FLASH_ROWS)
EPILOGUE_ROWS = (  # (kernel name, TPU kernel it replaces)
    ("bn_act_apply_f32", "paddle_tpu/ops/pallas_kernels.py:1039"),
    ("bn_act_bwd_f32", "paddle_tpu/ops/pallas_kernels.py:1131"),
)
# the timing case the training path launches each kernel at: the backward
# takes the fused kernel at seq 512 and the split pair at seq 2048
MAIN_PATH_SHAPE = {f"flash_{k}_{t}": shape
                   for k, shape in (("fwd", "bert"), ("bwd_fused", "bert"),
                                    ("bwd_dq", "long"), ("bwd_dkv", "long"))
                   for t in ("f32", "bf16", "fp16")}


def flash_kernels(dtype="f32"):
    """{name: KernelFunction} of the four flash kernels of one dtype
    ("f32", "bf16", "fp16" or "all")."""
    from paddle_tpu_torch.ops import flash_attention as fa

    kfs = {"f32": (fa.FLASH_FWD, fa.FLASH_BWD_FUSED, fa.FLASH_BWD_DQ,
                   fa.FLASH_BWD_DKV),
           "bf16": (fa.FLASH_FWD_BF16, fa.FLASH_BWD_FUSED_BF16,
                    fa.FLASH_BWD_DQ_BF16, fa.FLASH_BWD_DKV_BF16),
           "fp16": (fa.FLASH_FWD_FP16, fa.FLASH_BWD_FUSED_FP16,
                    fa.FLASH_BWD_DQ_FP16, fa.FLASH_BWD_DKV_FP16)}
    pick = sum(kfs.values(), ()) if dtype == "all" else kfs[dtype]
    return {kf.name: kf for kf in pick}


def sass_counts(lib):
    """({function: HGMMA instructions in its SASS}, {function: ptxas's
    spill-store bytes}) of a built library (``cuobjdump -sass``)."""
    from paddle_tpu_torch import kernel_build

    cuobjdump = os.path.join(os.path.dirname(kernel_build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib.lib_path()],
                          capture_output=True, text=True, timeout=600,
                          check=True).stdout
    hgmma, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            hgmma[fn] = 0
        elif fn is not None and "HGMMA" in ln:
            hgmma[fn] += 1
    spills, fn = {}, None
    for ln in lib.build_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([A-Za-z0-9_]+)", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and fn is not None:
            spills[fn] = int(m.group(1))
    return hgmma, spills


def tensor_core_check(flash):
    """Every instance of the eight bf16 / fp16 flash kernels: its SASS (by
    ``cuobjdump -sass`` of the built library) holds HGMMA instructions,
    and ptxas reported no spill stores for it.  Prints one line each."""
    hgmma, spills = sass_counts(flash)
    for entry, (kernel, elem, widths) in TC_KERNELS.items():
        insts = sorted(n for n in hgmma if kernel in n and elem in n)
        got = sorted(int(re.search(r"ILi(\d+)E", n).group(1)) for n in insts)
        if got != list(widths):
            fail(f"{entry}: instances of {kernel} at tile widths {got} in "
                 f"the SASS, expected one per tile width {widths}")
        for n in insts:
            width = int(re.search(r"ILi(\d+)E", n).group(1))
            print("tensor_cores " + json.dumps({
                "kernel": entry, "tile_width": width, "hgmma": hgmma[n],
                "spill_stores": spills.get(n)}), flush=True)
            if hgmma[n] == 0:
                fail(f"{entry} (tile width {width}): no HGMMA in its SASS")
            if spills.get(n) != 0:
                fail(f"{entry} (tile width {width}): ptxas reports spill "
                     f"stores {spills.get(n)}")


# the f32 flash kernels (SIMT): the forward, the fused backward and the
# split pair, one instance per tile width and dropout (on, off), none may
# spill
SIMT_F32 = {"flash_fwd_f32": "flash_fwd_f32_kernel",
            "flash_bwd_fused_f32": "flash_bwd_fused_f32_kernel",
            "flash_bwd_dq_f32": "flash_bwd_dq_f32_kernel",
            "flash_bwd_dkv_f32": "flash_bwd_dkv_f32_kernel"}


def ptxas_registers(lib):
    """{function: registers} from ptxas's report in a library's build
    log."""
    regs, fn = {}, None
    for ln in lib.build_log.splitlines():
        m = re.search(r"Compiling entry function '([A-Za-z0-9_]+)'", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn is not None:
            regs[fn] = int(m.group(1))
    return regs


def simt_spill_check(flash):
    """Every instance of the four f32 flash kernels: one per tile width
    and dropout, and ptxas reported no spill stores for it.  Prints one
    line each, with its registers."""
    _, spills = sass_counts(flash)
    regs = ptxas_registers(flash)
    for entry, kernel in SIMT_F32.items():
        insts = {}
        for n in spills:
            m = re.search(kernel + r"ILi(\d+)ELb([01])E", n)
            if m:
                insts[int(m.group(1)), m.group(2) == "1"] = n
        want = [(w, drop) for w in (32, 64, 128) for drop in (False, True)]
        if sorted(insts) != want:
            fail(f"{entry}: instances (tile width, dropout) {sorted(insts)} "
                 f"in the build log, expected {want}")
        for (width, drop), n in sorted(insts.items()):
            print("simt_spills " + json.dumps({
                "kernel": entry, "tile_width": width, "dropout": drop,
                "registers": regs.get(n), "spill_stores": spills[n]}),
                flush=True)
            if spills[n] != 0:
                fail(f"{entry} (tile width {width}, dropout {drop}): ptxas "
                     f"reports spill stores {spills[n]}")


# the paged-decode kernel's instances: per page dtype (as mangled: f32,
# bf16, int8), the (elements a word, words a lane) it takes at each width
# 32, 64, 128, 256; each over GQA group bounds 1, 2, 4, 8, and FULL (the
# head dim is the width) or not, except int8's 8-byte words (never FULL)
PAGED_INSTANCES = {"f": ((4, 2),), "13__nv_bfloat16": ((8, 1),),
                   "a": ((16, 1), (8, 1))}


def paged_spill_check(paged):
    """Every instance of the paged-decode kernel, and ptxas reported no
    spill stores for it.  Prints one line each, with its registers."""
    _, spills = sass_counts(paged)
    regs = ptxas_registers(paged)
    want = sorted(
        (elem, epw, nv, d, g, full)
        for elem, words in PAGED_INSTANCES.items() for epw, nv in words
        for d in (32, 64, 128, 256) for g in (1, 2, 4, 8)
        for full in ((False,) if elem == "a" and epw == 8 else
                     (False, True)))
    insts = {}
    for n in spills:
        m = re.search(r"paged_decode_kernelI(f|13__nv_bfloat16|a)Li(\d+)ELi"
                      r"(\d+)ELi(\d+)ELi(\d+)ELb[01]ELb([01])E", n)
        if m:
            elem, epw, nv, d, g, full = m.groups()
            insts[elem, int(epw), int(nv), int(d), int(g), full == "1"] = n
    if sorted(insts) != want:
        fail(f"paged_decode_kernel: {len(insts)} instances in the build "
             f"log, expected {len(want)}: missing "
             f"{sorted(set(want) - set(insts))[:4]}")
    for key, n in sorted(insts.items()):
        elem, epw, nv, d, g, full = key
        print("paged_spills " + json.dumps({
            "elem": elem, "elements_a_word": epw, "words_a_lane": nv,
            "width": d, "max_group": g, "full": full,
            "registers": regs.get(n), "spill_stores": spills[n]}),
            flush=True)
        if spills[n] != 0:
            fail(f"paged_decode_kernel {key}: ptxas reports spill stores "
                 f"{spills[n]}")


def matmul_tensor_core_check(tc):
    """Every instance of the bf16 / fp16 kernel 9 (its TMA variants and
    its cp.async one, with an f32 and a 16-bit bias): HGMMA in its SASS
    and no spill stores.  Prints one line each."""
    from paddle_tpu_torch.ops.matmul_epilogue import TC_VARIANTS

    hgmma, spills = sass_counts(tc)
    insts = [n for n in hgmma
             if "mm_tma_kernel" in n or "mm_cpasync_kernel" in n]
    # one instance per variant, operand dtype and bias dtype
    if len(insts) != 4 * len(TC_VARIANTS):
        fail(f"kernel 9: {len(insts)} tensor-core instances in the SASS, "
             f"expected {4 * len(TC_VARIANTS)}")
    for n in sorted(insts):
        tag = "bf16" if "13__nv_bfloat16" in n else "fp16"
        m = re.search(r"mm_tma_kernelI\w+?(f|S\d*_)Li(\d+)ELi(\d+)ELi(\d+)"
                      r"ELi(\d+)E", n)
        if m:
            feed = (f"tma {64 * int(m.group(2))}x{m.group(3)}, "
                    f"{m.group(4)} stages, {m.group(5)} CTAs/SM")
            bias = "f32" if m.group(1) == "f" else tag
        else:
            feed = "cp.async 64x64"
            bias = "f32" if re.search(r"mm_cpasync_kernelI\w+?fEEv", n) \
                else tag
        print("tensor_cores " + json.dumps({
            "kernel": f"matmul_bias_act_{tag}", "variant": feed,
            "bias": bias, "hgmma": hgmma[n],
            "spill_stores": spills.get(n)}), flush=True)
        if hgmma[n] == 0:
            fail(f"matmul_bias_act_{tag} ({feed}, {bias} bias): no HGMMA in "
                 f"its SASS")
        if spills.get(n) != 0:
            fail(f"matmul_bias_act_{tag} ({feed}, {bias} bias): ptxas "
                 f"reports spill stores {spills.get(n)}")


def make_flash_case(seed, b, h, s, d, with_bias):
    """q, k, v, dO (b, h, s, d) and, with_bias, a padding bias from a 0/1
    mask whose rows keep between half and all of their keys."""
    import torch

    rng = np.random.RandomState(seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, s, d, device="cuda", generator=gen)
                   for _ in range(4))
    bias = None
    if with_bias:
        keep = rng.randint(s // 2, s + 1, size=b)
        mask = (np.arange(s)[None, :] < keep[:, None]).astype(np.float32)
        bias = torch.from_numpy((1.0 - mask) * -10000.0).cuda()
    return q, k, v, do, bias


def attended_pairs(b, h, sq, sk, causal):
    """(query, key) pairs the function needs: all, or those on and below
    the diagonal when causal."""
    if not causal:
        return b * h * sq * sk
    rows = np.minimum(np.arange(sq) + 1, sk)
    return b * h * int(rows.sum())


def flash_flops(name, case, causal):
    """The flops a flash kernel's function needs on ``case``: per attended
    pair and head dim, forward 4, dQ 6 [S, dP, dS K], dK/dV 8 [S, dP,
    dS^T Q, P^T dO], fused 10."""
    q, k = case[0], case[1]
    b, h, sq, d = q.shape
    per_pair = {"flash_fwd": 4, "flash_bwd_fused": 10, "flash_bwd_dq": 6,
                "flash_bwd_dkv": 8}[name.rsplit("_", 1)[0]]
    return per_pair * d * attended_pairs(b, h, sq, k.shape[2], causal)


def flash_bound(name, case, causal):
    """(bound_ms, bound_by): each input read once and each output written
    once over HBM bandwidth, against the flops the function needs (per
    attended pair and head dim: forward 4, dQ 6 [S, dP, dS K], dK/dV 8
    [S, dP, dS^T Q, P^T dO], fused 10) over the card's peak for their
    type: f32 outside the tensor cores for the f32 kernels, the bf16 or
    fp16 tensor cores for the bf16 and fp16 ones.  q, k, v, dO and the
    outputs count 4 or 2 bytes an element; lse, delta and the bias 4."""
    q, k, _, _, bias = case
    b, h, sq, d = q.shape
    sk = k.shape[2]
    qn, kn, rows = q.numel(), k.numel(), b * h * sq
    bias_n = 0 if bias is None else bias.numel()
    kind = name.rsplit("_", 1)[0]       # flash_fwd, flash_bwd_fused, ...
    data, f32 = {   # elements read + written: (in q's dtype, in f32)
        "flash_fwd": (qn + 2 * kn + qn, bias_n + rows),
        "flash_bwd_fused": (2 * qn + 2 * kn + qn + 2 * kn,
                            2 * rows + bias_n),
        "flash_bwd_dq": (2 * qn + 2 * kn + qn, 2 * rows + bias_n),
        "flash_bwd_dkv": (2 * qn + 2 * kn + 2 * kn, 2 * rows + bias_n),
    }[kind]
    bf16 = name.endswith(("_bf16", "_fp16"))     # 2 bytes, tensor cores
    flops = flash_flops(name, case, causal)
    t_bytes = ((2 if bf16 else 4) * data + 4 * f32) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def grad_err(got, want):
    """max |got - want|, after checking |got - want| <= atol + rtol|want|."""
    diff = (got - want).abs()
    if not bool((diff <= GRAD_ATOL + GRAD_RTOL * want.abs()).all()):
        return None
    return float(diff.max())


def check_flash(name, case, causal, rate):
    """The four kernels against the plain versions on one case; returns
    {kernel: max abs error}."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    q, k, v, do, bias = case
    b, h, s, d = q.shape
    scale = d ** -0.5
    seed = torch.tensor([20260], dtype=torch.int64, device="cuda")
    keep = fa.flash_dropout_mask(b, h, s, s, rate, seed) if rate else None
    out, lse = fa.flash_fwd(q, k, v, bias, scale, causal, rate, seed)
    want_out, want_lse = fa.flash_fwd_reference(q, k, v, bias, scale,
                                                causal, rate, keep)
    errs = {"flash_fwd_f32": float((out - want_out).abs().max())}
    lse_err = float((lse - want_lse).abs().max())
    if not torch.isfinite(out).all() or max(errs["flash_fwd_f32"],
                                            lse_err) > KERNEL_ATOL:
        fail(f"flash {name} rate {rate}: forward vs plain max |err| out "
             f"{errs['flash_fwd_f32']:.3e} lse {lse_err:.3e} > "
             f"{KERNEL_ATOL}")
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    fa.attention_reference(qa, ka, va, bias, causal, scale, rate,
                           keep=keep).backward(do)
    want = (qa.grad, ka.grad, va.grad)
    delta = (do * out).sum(-1)
    args = (q, k, v, bias, do, lse, delta, scale, causal, rate, seed)
    got = {"flash_bwd_fused_f32": fa.bwd_fused(*args),
           "flash_bwd_dq_f32": (fa.bwd_dq(*args),),
           "flash_bwd_dkv_f32": fa.bwd_dkv(*args)}
    torch.cuda.synchronize()
    for kname, grads in got.items():
        pairs = {"flash_bwd_fused_f32": zip(grads, want),
                 "flash_bwd_dq_f32": zip(grads, want[:1]),
                 "flash_bwd_dkv_f32": zip(grads, want[1:])}[kname]
        es = [grad_err(g, w) for g, w in pairs]
        if None in es:
            fail(f"flash {name} rate {rate}: {kname} gradients outside "
                 f"rtol {GRAD_RTOL} / atol {GRAD_ATOL} of autograd's")
        errs[kname] = max(es)
    # no atomics, and the fused kernel sums dQ's shares in kv order: a
    # second call of each backward, the same bits
    again = (*fa.bwd_fused(*args), fa.bwd_dq(*args), *fa.bwd_dkv(*args))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(
            again, got["flash_bwd_fused_f32"] + got["flash_bwd_dq_f32"]
            + got["flash_bwd_dkv_f32"])):
        fail(f"flash {name} rate {rate}: a second call of the f32 fused "
             f"backward or split pair gave other bits")
    if rate:
        n = keep.numel()
        kept = float(keep.sum(dtype=torch.float64))
        sigma = (n * rate * (1 - rate)) ** 0.5
        if abs(kept - n * (1 - rate)) > 4 * sigma:
            fail(f"flash {name}: keep rate {kept / n:.6f} is more than 4 "
                 f"sigma from {1 - rate}")
        again, _ = fa.flash_fwd(q, k, v, bias, scale, causal, rate, seed)
        if not torch.equal(again, out):
            fail(f"flash {name}: the same seed gave another output")
    print("flash_check " + json.dumps({"case": name, "causal": causal,
                                       "dropout": rate, "lse_err": lse_err,
                                       **errs}), flush=True)
    return errs


def time_events(fn, args_sets, calls=10) -> float:
    """Mean milliseconds per call between CUDA events (no graph), for a
    library call that runs autograd or its own RNG."""
    import torch

    for args in args_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(calls):
        fn(*args_sets[i % len(args_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def time_flash(name, cases, causal, rate, dt="f32"):
    """ms, plain_ms, library_ms and the bound of every flash kernel of
    dtype ``dt`` on ``cases`` (copies of one shape, rotated to keep the
    L2 cold); for bf16 the q, k, v, dO of ``cases`` are bf16 and the
    library call (SDPA) runs in bf16 too, and likewise for fp16."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fa

    q0, k0 = cases[0][0], cases[0][1]
    b, h, s, d = q0.shape
    scale = d ** -0.5
    seed = torch.tensor([7], dtype=torch.int64, device="cuda")
    sets = []
    for q, k, v, do, bias in cases:
        keep = fa.flash_dropout_mask(b, h, s, s, rate, seed) if rate else None
        out, lse = fa.flash_fwd(q, k, v, bias, scale, causal, rate, seed)
        sets.append((q, k, v, do, bias, keep, out, lse,
                     (do.float() * out.float()).sum(-1)))
    kern = {
        f"flash_fwd_{dt}": lambda q, k, v, do, bias, keep, out, lse, delta:
            fa.flash_fwd(q, k, v, bias, scale, causal, rate, seed),
        f"flash_bwd_fused_{dt}": lambda q, k, v, do, bias, keep, out, lse,
            delta: fa.bwd_fused(q, k, v, bias, do, lse, delta, scale,
                                causal, rate, seed),
        f"flash_bwd_dq_{dt}": lambda q, k, v, do, bias, keep, out, lse,
            delta: fa.bwd_dq(q, k, v, bias, do, lse, delta, scale, causal,
                             rate, seed),
        f"flash_bwd_dkv_{dt}": lambda q, k, v, do, bias, keep, out, lse,
            delta: fa.bwd_dkv(q, k, v, bias, do, lse, delta, scale, causal,
                              rate, seed),
    }

    def plain_fwd(q, k, v, do, bias, keep, out, lse, delta):
        return fa.flash_fwd_reference(q, k, v, bias, scale, causal, rate,
                                      keep)

    def plain_bwd(q, k, v, do, bias, keep, out, lse, delta):
        return fa.flash_bwd_reference(q, k, v, bias, out, lse, do, scale,
                                      causal, rate, keep)

    def sdpa(q, k, v, mask):
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=rate, is_causal=causal,
            scale=scale)

    def sdpa_args(q, k, v, do, bias, *_):
        """q, k, v, the mask, and SDPA's output with its graph: the
        forward runs here, outside the backward's timed region."""
        mask = None if bias is None else bias[:, None, None, :].to(q.dtype)
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        return (*qkv, mask, sdpa(*qkv, mask), do)

    def sdpa_bwd(q, k, v, mask, out, do):
        return torch.autograd.grad(out, (q, k, v), do, retain_graph=True)

    lib_sets = [sdpa_args(*st) for st in sets]
    with torch.no_grad():
        lib_fwd = time_events(lambda q, k, v, mask, *_: sdpa(q, k, v, mask),
                              lib_sets)
    lib_bwd = time_events(sdpa_bwd, lib_sets)
    plain = {"fwd": time_ms(plain_fwd, sets, per_graph=5, replays=4),
             "bwd": time_ms(plain_bwd, sets, per_graph=5, replays=4)}
    rows = {}
    for kname, fn in kern.items():
        bound_ms, bound_by = flash_bound(kname, cases[0], causal)
        fwd = kname.startswith("flash_fwd")
        rows[kname] = {"shape": name, "b": b, "h": h, "s": s, "d": d,
                       "causal": causal, "dropout": rate,
                       "bias": cases[0][4] is not None,
                       "ms": time_ms(fn, sets, per_graph=10, replays=5),
                       "plain_ms": plain["fwd" if fwd else "bwd"],
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": lib_fwd if fwd else lib_bwd}
        # achieved rate, and the share of the bound this time reaches
        rows[kname]["tflops"] = (flash_flops(kname, cases[0], causal)
                                 / rows[kname]["ms"] * 1e-9)
        rows[kname]["bound_share"] = bound_ms / rows[kname]["ms"]
        print(f"flash_time {kname} " + json.dumps(rows[kname]), flush=True)
    pair = [rows[f"flash_bwd_{k}_{dt}"] for k in ("dq", "dkv")]
    pair_ms = pair[0]["ms"] + pair[1]["ms"]
    pair_bound = pair[0]["bound_ms"] + pair[1]["bound_ms"]
    print(f"flash_time_split_pair_{dt} " + json.dumps({
        "shape": name, "dropout": rate, "ms": pair_ms,
        "bound_ms": pair_bound,
        "bound_share": pair_bound / pair_ms, "library_ms": lib_bwd,
        "fused_ms": rows[f"flash_bwd_fused_{dt}"]["ms"]}), flush=True)
    if dt == "f32" and name == "bert":
        # the training path's backward at seq 512 against the two others
        # that compute it: the split pair and SDPA's backward
        fused = rows["flash_bwd_fused_f32"]
        print("flash_time_fused_vs_pair_f32 " + json.dumps({
            "shape": name, "dropout": rate, "fused_ms": fused["ms"],
            "pair_ms": pair_ms, "library_ms": lib_bwd,
            "fused_over_pair": fused["ms"] / pair_ms,
            "fused_over_library": fused["ms"] / lib_bwd,
            "bound_ms": fused["bound_ms"],
            "bound_share": fused["bound_share"]}), flush=True)
    return rows


def flash_phase():
    """Checks at both shapes, dropout 0 and 0.1, then times at the two
    training configurations (padding bias, dropout 0.1, not causal): the
    BERT shape, whose backward takes the fused kernel, and s=2048, whose
    backward takes the split pair; s=2048 is timed again without dropout.
    Returns ({kernel: max abs err}, {shape: {kernel: timing row}}) of the
    dropout-0.1 runs."""
    import torch

    errs = {name: 0.0 for name, _ in FLASH_ROWS}
    bert = make_flash_case(1, 44, 12, 512, 64, True)
    long_bias = make_flash_case(2, 2, 12, 2048, 64, True)
    long_causal = make_flash_case(3, 2, 12, 2048, 64, False)
    for name, case, causal in (("bert", bert, False),
                               ("long", long_bias, False),
                               ("long_causal", long_causal, True)):
        for rate in (0.0, 0.1):
            for kname, e in check_flash(name, case, causal, rate).items():
                errs[kname] = max(errs[kname], e)
    torch.cuda.empty_cache()
    times = {"bert": time_flash("bert", [bert, make_flash_case(
                 4, 44, 12, 512, 64, True)], False, 0.1),
             "long": time_flash("long", [long_bias] + [
                 make_flash_case(5 + i, 2, 12, 2048, 64, True)
                 for i in range(2)], False, 0.1)}
    # s=2048 without dropout: what the keep decisions cost the kernels
    time_flash("long", [long_bias] + [
        make_flash_case(5 + i, 2, 12, 2048, 64, True) for i in range(2)],
        False, 0.0)
    torch.cuda.empty_cache()
    return errs, times


# ==========================================================================
# training
# ==========================================================================
def reset_counts(kernels):
    for kf in kernels.values():
        kf.launches = 0


def train_phase(torch):
    """BERT-base pretraining at seq 512 (fused backward), then at seq
    2048 (split backward); returns the flash kernels' launches over both
    runs."""
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.tools.train_bert import train

    kernels = flash_kernels()
    layers = BertConfig().num_hidden_layers
    warmup, steps = 2, 10
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    run = train(BertConfig(), batch=44, seq=512, steps=steps, lr=1e-4,
                device="cuda", pad=True, warmup=warmup, log_every=1,
                amp=False)
    torch.cuda.synchronize()
    base = {n: kf.launches for n, kf in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = run.pop("losses")
    if not np.all(np.isfinite(losses)):
        fail(f"training losses not finite: {losses}")
    if not losses[-1] < losses[warmup]:
        fail(f"training loss did not fall from timed step 1 "
             f"({losses[warmup]}) to step {steps} ({losses[-1]})")
    n = layers * (warmup + steps)
    if (base["flash_fwd_f32"] != n or base["flash_bwd_fused_f32"] != n
            or base["flash_bwd_dq_f32"] or base["flash_bwd_dkv_f32"]):
        fail(f"BERT-base training launches {base}: expected {n} forward "
             f"and {n} fused backward (layers {layers} x steps "
             f"{warmup + steps}), no split backward")
    print("training " + json.dumps({
        "model": "BERT-base f32", "batch": 44, "seq": 512,
        "dropout": 0.1, "warmup_steps": warmup, "timed_steps": steps,
        "losses": losses, "ms_per_step": run["ms_per_step"],
        "tokens_per_s": run["tokens_per_s"],
        "max_memory_allocated": peak, "launches": base}), flush=True)
    del run
    torch.cuda.empty_cache()

    # the same widths at 2048 positions: the split backward kernels
    reset_counts(kernels)
    long_run = train(BertConfig(max_position_embeddings=2048), batch=2,
                     seq=2048, steps=2, lr=1e-4, device="cuda", pad=True,
                     warmup=1, log_every=1, amp=False)
    torch.cuda.synchronize()
    longl = {n: kf.launches for n, kf in kernels.items()}
    n = layers * 3
    if not np.all(np.isfinite(long_run["losses"])) or (
            longl["flash_fwd_f32"] != n or longl["flash_bwd_dq_f32"] != n
            or longl["flash_bwd_dkv_f32"] != n
            or longl["flash_bwd_fused_f32"]):
        fail(f"seq-2048 training: losses {long_run['losses']}, launches "
             f"{longl}: expected {n} forward, dQ and dK/dV, no fused")
    print("training_long " + json.dumps({
        "batch": 2, "seq": 2048, "losses": long_run["losses"],
        "ms_per_step": long_run["ms_per_step"], "launches": longl}),
        flush=True)
    del long_run
    torch.cuda.empty_cache()
    return {n: base[n] + longl[n] for n in kernels}


def card_vs_cpu(torch):
    """The whole model, 2 layers at full width: the port on the card and
    on the CPU from the same weights, 3 Adam steps.  Returns the card's
    f32 losses."""
    from paddle_tpu_torch.dygraph import jit_train_step, to_tensor
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import AdamOptimizer
    from paddle_tpu_torch.tools.train_bert import make_batch

    cfg = BertConfig(num_hidden_layers=2, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    batch = make_batch(cfg, 2, 128, seed=3, pad=True)
    cpu = BertForPretraining(cfg, device="cpu", seed=0)
    card = BertForPretraining(cfg, device="cuda", seed=1)
    card.set_dict(cpu.state_dict())
    launched = flash_kernels()["flash_fwd_f32"].launches
    losses = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        dev = next(iter(model.parameters())).device
        step = jit_train_step(model, AdamOptimizer(
            1e-4, parameter_list=model.parameters()),
            lambda m, i, l, a: m(i, l, attention_mask=a))
        inputs = [to_tensor(x, dev) for x in batch]
        losses[name] = [float(step(*inputs)) for _ in range(3)]
    if flash_kernels()["flash_fwd_f32"].launches != launched + 2 * 3:
        fail("card vs CPU: the card's run did not launch the flash kernels")
    rel = max(abs(a - b) / abs(a) for a, b in zip(losses["cpu"],
                                                  losses["cuda"]))
    print("card_vs_cpu " + json.dumps({**losses, "max_rel_diff": rel,
                                       "rtol": LOSS_RTOL}), flush=True)
    if not rel <= LOSS_RTOL:
        fail(f"card vs CPU losses differ by {rel:.3e} > {LOSS_RTOL}")
    return losses["cuda"]


# ==========================================================================
# bf16: the flash kernels, and BERT-base under AMP O1 / O2
# ==========================================================================
def ulps_off(got, want, unit=2.0 ** -8) -> float:
    """max |got - want| in ``unit``s of the largest |want| (bf16 ulps:
    2^-8 of it)."""
    scale = unit * float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / scale


def low_case(case, amp_dtype="bfloat16"):
    q, k, v, do, bias = case
    import torch

    dt = getattr(torch, amp_dtype)
    return (*(t.to(dt) for t in (q, k, v, do)), bias)


def check_flash_low(name, case, causal, rate, amp_dtype="bfloat16"):
    """The four bf16 or fp16 kernels against their plain versions (which
    round where the kernels round), the keep rate, determinism, and the
    kernels against the f32 ones on the same inputs (exact in f32);
    returns {kernel: max abs error}."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    tag, unit, limit = FLASH_LOW[amp_dtype]
    dt = getattr(torch, amp_dtype)
    q, k, v, do, bias = case
    b, h, s, d = q.shape
    scale = d ** -0.5
    seed = torch.tensor([20261], dtype=torch.int64, device="cuda")
    keep = fa.flash_dropout_mask(b, h, s, s, rate, seed) if rate else None
    out, lse = fa.flash_fwd(q, k, v, bias, scale, causal, rate, seed)
    want_out, want_lse = fa.flash_fwd_reference(q, k, v, bias, scale,
                                                causal, rate, keep)
    fwd = f"flash_fwd_{tag}"
    ulps = {fwd: ulps_off(out, want_out, unit)}
    errs = {fwd: float((out.float() - want_out.float()).abs().max())}
    lse_err = float((lse - want_lse).abs().max())
    if (out.dtype != dt or not torch.isfinite(out).all()
            or ulps[fwd] > limit or lse_err > KERNEL_ATOL):
        fail(f"flash {tag} {name} rate {rate}: forward {out.dtype} vs plain "
             f"{ulps[fwd]:.2f} ulps (limit {limit}), lse {lse_err:.3e} "
             f"(limit {KERNEL_ATOL})")
    want = fa.flash_bwd_reference(q, k, v, bias, out, lse, do, scale, causal,
                                  rate, keep)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, bias, do, lse, delta, scale, causal, rate, seed)
    got = {f"flash_bwd_fused_{tag}": (fa.bwd_fused(*args), want),
           f"flash_bwd_dq_{tag}": ((fa.bwd_dq(*args),), want[:1]),
           f"flash_bwd_dkv_{tag}": (fa.bwd_dkv(*args), want[1:])}
    torch.cuda.synchronize()
    for kname, (grads, wants) in got.items():
        us = [ulps_off(g, w, unit) for g, w in zip(grads, wants)]
        if max(us) > limit or any(g.dtype != dt for g in grads):
            fail(f"flash {tag} {name} rate {rate}: {kname} gradients "
                 f"{max(us):.2f} ulps from the plain version's (limit "
                 f"{limit})")
        ulps[kname] = max(us)
        errs[kname] = max(float((g.float() - w.float()).abs().max())
                          for g, w in zip(grads, wants))
    # the kernels against the f32 ones on the same inputs: apart by about
    # a rounding of their dtype, far above the f32 kernels' noise
    f32 = [t.float() for t in (q, k, v, do)]
    o32, l32 = fa.flash_fwd(*f32[:3], bias, scale, causal, rate, seed)
    g32 = fa.flash_bwd(*f32[:3], bias, o32, l32, f32[3], scale, causal,
                       rate, seed)
    g16 = fa.flash_bwd(q, k, v, bias, out, lse, do, scale, causal, rate,
                       seed)
    vs_f32 = [ulps_off(a, w, unit) for a, w in zip((out, *g16),
                                                   (o32, *g32))]
    if not all(2.0 ** -4 < u <= limit for u in vs_f32):
        fail(f"flash {tag} {name} rate {rate}: {tag} vs f32 kernels "
             f"{vs_f32} ulps, expected a {tag} rounding (0.0625, {limit}]")
    if rate:
        again, _ = fa.flash_fwd(q, k, v, bias, scale, causal, rate, seed)
        if not torch.equal(again, out):
            fail(f"flash {tag} {name}: the same seed gave another output")
        n = keep.numel()
        kept = float(keep.sum(dtype=torch.float64))
        sigma = (n * rate * (1 - rate)) ** 0.5
        if abs(kept - n * (1 - rate)) > 4 * sigma:
            fail(f"flash {tag} {name}: keep rate {kept / n:.6f} is more "
                 f"than 4 sigma from {1 - rate}")
    print(f"flash_check_{tag} " + json.dumps({
        "case": name, "causal": causal, "dropout": rate, "d": d,
        "lse_err": lse_err, "ulps": ulps, f"{tag}_vs_f32_ulps": vs_f32,
        **errs}), flush=True)
    return errs


def fused_occupancy(tag):
    """The bf16 / fp16 fused kernel's CTAs resident on one SM at tile
    widths 64 and 128 (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    and the waves its grid (one CTA per kv tile and b h) takes at the
    BERT-base shape (b 44, h 12, s 512): one line each."""
    import ctypes

    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for d in (64, 128):
        blocks = ctypes.c_int(0)
        err = fa.FLASH.load().paddle_flash_fused_occupancy(
            d, int(tag == "fp16"), ctypes.byref(blocks))
        if err != 0 or blocks.value < 1:
            fail(f"flash_bwd_fused_{tag}: occupancy query at d {d} gave "
                 f"error {err}, {blocks.value} CTAs per SM")
        grid = -(-512 // 64) * 44 * 12
        print("fused_occupancy " + json.dumps({
            "kernel": f"flash_bwd_fused_{tag}", "tile_width": d,
            "ctas_per_sm": blocks.value, "resident": blocks.value * sms,
            "grid_bert": grid, "waves_bert": grid / (blocks.value * sms)}),
            flush=True)


def flash_low_phase(amp_dtype="bfloat16"):
    """Phase a (bf16) or v (fp16): checks at the BERT-base and long
    shapes, causal and not, dropout 0 and 0.1; then phase b's times at
    the two training configurations.  Returns ({kernel: max abs err},
    {shape: rows})."""
    import torch

    tag = FLASH_LOW[amp_dtype][0]
    errs = {n.replace("_f32", f"_{tag}"): 0.0 for n, _ in FLASH_ROWS}
    # fp16 draws other inputs than bf16 (its own seeds)
    s0 = 11 if amp_dtype == "bfloat16" else 31
    bert = low_case(make_flash_case(s0, 44, 12, 512, 64, True), amp_dtype)
    long_bias = low_case(make_flash_case(s0 + 1, 2, 12, 2048, 64, True),
                         amp_dtype)
    long_causal = low_case(make_flash_case(s0 + 2, 2, 12, 2048, 64, False),
                           amp_dtype)
    for name, case, causal in (("bert", bert, False),
                               ("bert_causal", bert, True),
                               ("long", long_bias, False),
                               ("long_causal", long_causal, True)):
        for rate in (0.0, 0.1):
            for kname, e in check_flash_low(name, case, causal, rate,
                                            amp_dtype).items():
                errs[kname] = max(errs[kname], e)
    torch.cuda.empty_cache()
    times = {"bert": time_flash("bert", [bert, low_case(make_flash_case(
                 s0 + 3, 44, 12, 512, 64, True), amp_dtype)], False, 0.1,
                 tag),
             "long": time_flash("long", [long_bias] + [
                 low_case(make_flash_case(s0 + 4 + i, 2, 12, 2048, 64, True),
                          amp_dtype) for i in range(2)], False, 0.1, tag)}
    fused_occupancy(tag)
    torch.cuda.empty_cache()
    return errs, times


def gelu_kernels():
    from paddle_tpu_torch.ops import gelu

    return {"gelu_fwd_bf16": gelu.GELU_FWD_BF16,
            "gelu_bwd_bf16": gelu.GELU_BWD_BF16,
            "gelu_fwd_fp16": gelu.GELU_FWD_FP16,
            "gelu_bwd_fp16": gelu.GELU_BWD_FP16}


def train_amp(torch, level, cfg, batch, seq, warmup, steps,
              amp_dtype="bfloat16"):
    """One AMP run through ``tools/train_bert.train``; returns the run,
    the launches of every flash kernel during it, and the gelu kernels'
    (in ``run["gelu_launches"]``)."""
    from paddle_tpu_torch.tools.train_bert import train

    kernels = flash_kernels("all")
    gk = gelu_kernels()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    reset_counts(gk)
    run = train(cfg, batch=batch, seq=seq, steps=steps, lr=1e-4,
                device="cuda", pad=True, warmup=warmup, log_every=1,
                amp=True, amp_level=level, amp_dtype=amp_dtype)
    torch.cuda.synchronize()
    run["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    run["gelu_launches"] = {n: kf.launches for n, kf in gk.items()}
    return run, {n: kf.launches for n, kf in kernels.items()}


def check_amp_run(what, run, launches, n_steps, layers, split, tag="bf16"):
    """Losses finite and falling, and per step one launch per layer of
    the forward and of the backward (fused, or the split pair) of the AMP
    dtype ``tag``, and no flash kernel of another dtype."""
    losses = run["losses"]
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{what}: losses {losses} not finite or not falling")
    n = layers * n_steps
    want = {name: 0 for name in launches}
    want[f"flash_fwd_{tag}"] = n
    for kname in ((f"flash_bwd_dq_{tag}", f"flash_bwd_dkv_{tag}") if split
                  else (f"flash_bwd_fused_{tag}",)):
        want[kname] = n
    if launches != want:
        fail(f"{what}: flash launches {launches}, expected {want} (layers "
             f"{layers} x steps {n_steps}, {tag} only)")


def amp_train_phase(torch, level, warmup, steps, amp_dtype="bfloat16"):
    """Phase c / w (O1) or d / x (O2): BERT-base at batch 44 x seq 512
    under AMP in ``amp_dtype``; for O1 also 3 steps at seq 2048 (the split
    backward).  Returns the flash kernels' launches of that dtype, and
    for O2, whose gelus run in the AMP dtype (under O1 the bias add
    promotes them to f32), the gelu kernels' too: one forward and one
    backward per step for each layer's FFN and for the MLM head's
    transform."""
    from paddle_tpu_torch.models.bert import BertConfig

    tag = FLASH_LOW[amp_dtype][0]
    layers = BertConfig().num_hidden_layers
    run, launches = train_amp(torch, level, BertConfig(), 44, 512, warmup,
                              steps, amp_dtype)
    check_amp_run(f"AMP {level} {tag} BERT-base", run, launches,
                  warmup + steps, layers, split=False, tag=tag)
    gl = run["gelu_launches"]
    n_gelu = (layers + 1) * (warmup + steps) if level == "O2" else 0
    want_gl = {n: n_gelu if n.endswith(tag) else 0 for n in gl}
    if gl != want_gl:
        fail(f"AMP {level} {tag} BERT-base: gelu launches {gl}, expected "
             f"{want_gl}")
    if level == "O2":
        # every parameter in the AMP dtype; every one the optimizer has
        # updated (all but the pooler and the NSP head, which the MLM loss
        # gives no gradient) has an f32 master and f32 moments
        params = run["model"].parameters()
        states = [run["optimizer"]._state.get(id(p)) for p in params]
        updated = [st for st in states if st is not None]
        if (any(p.dtype != getattr(torch, amp_dtype) for p in params)
                or len(updated) != len(params) - 4
                or any(st[key].dtype != torch.float32 for st in updated
                       for key in ("master", "m1", "m2"))):
            fail(f"AMP O2: a parameter is not {tag}, or an updated one "
                 f"lacks an f32 master and f32 moments")
    print("training_amp " + json.dumps({
        "model": f"BERT-base AMP {level} {tag}", "batch": 44, "seq": 512,
        "dropout": 0.1, "warmup_steps": warmup, "timed_steps": steps,
        "losses": run["losses"], "ms_per_step": run["ms_per_step"],
        "tokens_per_s": run["tokens_per_s"],
        "max_memory_allocated": run["max_memory_allocated"],
        "launches": launches, "gelu_launches": gl}), flush=True)
    total = dict(launches)
    del run
    if level == "O2":
        return gl
    if level == "O1":
        long_run, longl = train_amp(
            torch, level, BertConfig(max_position_embeddings=2048), 2, 2048,
            1, 2, amp_dtype)
        check_amp_run(f"AMP O1 {tag} seq 2048", long_run, longl, 3, layers,
                      split=True, tag=tag)
        print("training_amp_long " + json.dumps({
            "model": f"BERT-base AMP O1 {tag}",
            "batch": 2, "seq": 2048, "losses": long_run["losses"],
            "ms_per_step": long_run["ms_per_step"], "launches": longl}),
            flush=True)
        total = {n: total[n] + longl[n] for n in total}
        del long_run
    torch.cuda.empty_cache()
    return {n: c for n, c in total.items() if n.endswith(f"_{tag}")}


def amp_card_vs_cpu(torch, f32_losses, amp_dtype="bfloat16"):
    """Phase e (bf16) or y (fp16): 2 layers at full width, the same
    weights and batch as the f32 card-vs-CPU phase, 3 Adam steps under
    AMP O1 and O2 on the card (bf16 or fp16 kernels) and on the CPU
    (plain versions)."""
    from paddle_tpu_torch.dygraph import jit_train_step, to_tensor
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import AdamOptimizer
    from paddle_tpu_torch.tools.train_bert import make_batch

    cfg = BertConfig(num_hidden_layers=2, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    # fp16 GEMMs on a host CPU without fp16 arithmetic run PyTorch's slow
    # fallback, most of this phase's time at phase 8's batch: fp16 takes
    # 1 x 64 tokens, and its own f32 card run for the f32 comparison
    b, s = (2, 128) if amp_dtype == "bfloat16" else (1, 64)
    batch = make_batch(cfg, b, s, seed=3, pad=True)
    weights = BertForPretraining(cfg, device="cpu", seed=0).state_dict()
    if (b, s) != (2, 128):
        model = BertForPretraining(cfg, device="cuda", seed=1)
        model.set_dict(weights)
        step = jit_train_step(model, AdamOptimizer(
            1e-4, parameter_list=model.parameters()),
            lambda m, i, l, a: m(i, l, attention_mask=a))
        inputs = [to_tensor(x, "cuda") for x in batch]
        f32_losses = [float(step(*inputs)) for _ in range(3)]
    tag = FLASH_LOW[amp_dtype][0]
    fwd16 = flash_kernels(tag)[f"flash_fwd_{tag}"]
    result = {"batch": b, "seq": s}
    for level in ("O1", "O2"):
        losses = {}
        for dev in ("cpu", "cuda"):
            model = BertForPretraining(cfg, device=dev, seed=1)
            model.set_dict(weights)
            step = jit_train_step(model, AdamOptimizer(
                1e-4, parameter_list=model.parameters()),
                lambda m, i, l, a: m(i, l, attention_mask=a), amp=True,
                amp_dtype=amp_dtype, amp_level=level)
            inputs = [to_tensor(x, dev) for x in batch]
            launched = fwd16.launches
            losses[dev] = [float(step(*inputs)) for _ in range(3)]
            if dev == "cuda" and fwd16.launches != launched + 2 * 3:
                fail(f"AMP {level} {tag} card vs CPU: the card's run did "
                     f"not launch the {tag} flash kernels")
        rel = max(abs(a - b) / abs(a) for a, b in zip(losses["cpu"],
                                                      losses["cuda"]))
        vs_f32 = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                         f32_losses))
        result[level] = {**losses, "max_rel_diff": rel, "rtol":
                         AMP_LOSS_RTOL, "vs_f32_max_rel": vs_f32}
        if not rel <= AMP_LOSS_RTOL:
            fail(f"AMP {level} {tag} card vs CPU losses differ by "
                 f"{rel:.3e} > {AMP_LOSS_RTOL}")
        if level == "O1" and not vs_f32 > LOSS_RTOL:
            fail(f"AMP O1 {tag} losses within {vs_f32:.3e} of the f32 run's "
                 f"(f32 tolerance {LOSS_RTOL}): {tag} did not run")
    print(f"amp_card_vs_cpu{'' if tag == 'bf16' else '_' + tag} "
          + json.dumps(result), flush=True)


# ==========================================================================
# the conv epilogue kernels, and ResNet-50 static training
# ==========================================================================
def resnet50_epilogue_shapes(amp_dtype=None, nhwc=False):
    """[(conv-output shape, has z)] of the 49 fused_conv_bn_act ops of the
    ResNet-50 training program (f32, or AMP in ``amp_dtype``) at batch
    128, 224x224, in program order; ``nhwc``: as the NHWC layout pass
    leaves them (channels last)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.tools.train_resnet import build_program
    from paddle_tpu_torch.utils import flags

    names = ("FLAGS_cuda_fuse", "FLAGS_cuda_nhwc")
    prev = {k: flags.get_flag(k) for k in names}
    flags.set_flags({"FLAGS_cuda_fuse": "1",
                     "FLAGS_cuda_nhwc": "1" if nhwc else "0"})
    try:
        main, _, loss, acc1 = build_program(
            50, 224, 1000, amp=amp_dtype is not None,
            amp_dtype=amp_dtype or "bfloat16")
        rew = fluid.Executor("cpu")._apply_ir_passes(main, [loss.name,
                                                            acc1.name])
    finally:
        flags.set_flags(prev)
    blk = rew.global_block()
    return [(tuple(128 if d == -1 else d
                   for d in blk.var(op.output("ConvOut")[0]).shape),
             bool(op.input("Z")))
            for op in blk.ops if op.type == "fused_conv_bn_act"]


def epilogue_inputs(shape, with_z, seed, c_axis=1):
    """x (and z) of ``shape`` and four per-channel vectors on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[c_axis]
    x = torch.randn(shape, device="cuda", generator=gen)
    z = torch.randn(shape, device="cuda", generator=gen) if with_z else None
    vecs = [torch.randn(c, device="cuda", generator=gen) for _ in range(4)]
    return x, z, vecs


def epilogue_bytes(shape, with_z, bwd, c_axis=1):
    """Bytes each call must move: every input read once, every output
    written once (f32): forward x (and z) in, y out; backward y, dy, x in,
    dx (and g) out; plus the per-channel vectors."""
    n = int(np.prod(shape))
    c = shape[c_axis]
    if bwd:
        return 4 * (n * (4 + with_z) + 4 * c)
    return 4 * (n * (2 + with_z) + 2 * c)


def bwd_err(dx, g, rdx, rg):
    """Kernel 8's largest |kernel - plain| over dx and, if written, g."""
    err = float((dx.float() - rdx.float()).abs().max())
    if g is not None:
        err = max(err, float((g.float() - rg.float()).abs().max()))
    return err


def check_epilogue():
    """Kernels 7 and 8 against their plain versions; {kernel: max err}."""
    import torch

    from paddle_tpu_torch.ops import bn_act as ba

    cases = [("path-112x112", (128, 64, 112, 112), 1, False),
             ("path-56x56-z", (128, 256, 56, 56), 1, True),
             ("ragged-nchw", (3, 37, 13, 11), 1, True),
             ("ragged-nhwc", (3, 13, 11, 37), 3, True),
             ("channels-last-mc", (4096, 64), 1, True)]
    errs = {"bn_act_apply_f32": 0.0, "bn_act_bwd_f32": 0.0}
    for name, shape, c_axis, with_z in cases:
        x, z, (a, b, mean, cx) = epilogue_inputs(shape, with_z, 11, c_axis)
        row = {"case": name, "shape": list(shape), "c_axis": c_axis}
        for act in ba.ACTS:
            for zz in ((None, z) if with_z else (None,)):
                got = ba.bn_act_apply(x, a, b, zz, act, c_axis)
                want = ba.bn_act_apply_reference(x, a, b, zz, act, c_axis)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                exact = act in ("", "relu")
                if (exact and not torch.equal(got, want)) or err > \
                        EPILOGUE_TOL * (1 + float(want.abs().max())):
                    fail(f"bn_act_apply_f32 {name} act {act!r} z "
                         f"{zz is not None}: max |err| {err:.3e}")
                row[f"fwd {act or 'none'}{' z' if zz is not None else ''}"] \
                    = err
                errs["bn_act_apply_f32"] = max(errs["bn_act_apply_f32"], err)
            del got, want
        y = torch.relu(x)
        for act in ("", "relu"):
            for want_g in (False, True):
                dx, g = ba.bn_act_bwd_apply(y, z if z is not None else x, x,
                                            a, mean, cx, b, act, c_axis,
                                            want_g)
                rdx, rg = ba.bn_act_bwd_reference(
                    y, z if z is not None else x, x, a, mean, cx, b, act,
                    c_axis, want_g)
                torch.cuda.synchronize()
                err = bwd_err(dx, g, rdx, rg)
                if not torch.equal(dx, rdx) or (want_g and
                                                 not torch.equal(g, rg)):
                    fail(f"bn_act_bwd_f32 {name} act {act!r} want_g "
                         f"{want_g}: not equal to the plain version "
                         f"(max |err| {err:.3e})")
                row[f"bwd {act or 'none'}{' g' if want_g else ''}"] = err
                errs["bn_act_bwd_f32"] = max(errs["bn_act_bwd_f32"], err)
                del dx, g, rdx, rg
        print("epilogue_check " + json.dumps(row), flush=True)
        del x, z, y
        torch.cuda.empty_cache()
    return errs


def path_layout(amp_dtype=None):
    """(nhwc, channel axis) of the ResNet-50 program's convolutions on
    the card (f32, or AMP in ``amp_dtype``): ``FLAGS_cuda_nhwc`` resolved
    for a CUDA place, as the executor resolves it (``auto``: NHWC for
    bf16 and fp16 convolutions only)."""
    import torch

    from paddle_tpu_torch.utils.flags import cuda_nhwc_enabled

    nhwc = cuda_nhwc_enabled(torch.device("cuda"),
                             low_precision_convs=amp_dtype is not None)
    return nhwc, 3 if nhwc else 1


def time_epilogue():
    """Each kernel against its plain version (bit for bit, relu) at
    every one of the 49 shapes one ResNet-50 training step gives it, in
    NCHW and in NHWC; then both timed over those 49 calls in the layout
    the f32 main path runs (every call on its own tensors) by CUDA-graph
    replay; with the byte bound of those calls and the two largest
    shapes' own rows.  Returns {kernel: row}."""
    import torch

    from paddle_tpu_torch.ops import bn_act as ba

    path_nhwc, _ = path_layout()
    rows = {}
    for nhwc in sorted((False, True), key=lambda v: v == path_nhwc):
        c_axis = 3 if nhwc else 1
        shapes = resnet50_epilogue_shapes(nhwc=nhwc)
        if len(shapes) != 49:
            fail(f"the ResNet-50 program has {len(shapes)} fused conv "
                 f"chains, expected 49")
        fwd_sets, bwd_sets = [], []
        for i, (shape, with_z) in enumerate(shapes):
            x, z, (a, b, mean, cx) = epilogue_inputs(shape, with_z, 100 + i,
                                                     c_axis)
            fwd_sets.append((x, a, b, z))
            bwd_sets.append((torch.relu(x), torch.randn_like(x), x, a, mean,
                             cx, b, with_z))
        kernels = (
            ("bn_act_apply_f32", fwd_sets,
             lambda x, a, b, z: ba.bn_act_apply(x, a, b, z, "relu", c_axis),
             lambda x, a, b, z: ba.bn_act_apply_reference(
                 x, a, b, z, "relu", c_axis), False),
            ("bn_act_bwd_f32", bwd_sets,
             lambda y, dy, x, cg, m, cx, c0, wg: ba.bn_act_bwd_apply(
                 y, dy, x, cg, m, cx, c0, "relu", c_axis, wg),
             lambda y, dy, x, cg, m, cx, c0, wg: ba.bn_act_bwd_reference(
                 y, dy, x, cg, m, cx, c0, "relu", c_axis, wg), True))
        for name, sets, kern, plain, bwd in kernels:
            for (shape, _), args in zip(shapes, sets):   # every path shape
                got, want = kern(*args), plain(*args)
                if bwd:
                    same = torch.equal(got[0], want[0]) and (
                        got[1] is None or torch.equal(got[1], want[1]))
                else:
                    same = torch.equal(got, want)
                if not same:
                    fail(f"{name} differs from its plain version at "
                         f"{shape} (c_axis {c_axis})")
                del got, want
        print("epilogue_check " + json.dumps(
            {"case": f"ResNet-50 path, {'NHWC' if nhwc else 'NCHW'}",
             "shapes": 49, "c_axis": c_axis, "bit_exact": True}), flush=True)
        if nhwc != path_nhwc:
            del fwd_sets, bwd_sets, kernels
            torch.cuda.empty_cache()
            continue
        for name, sets, kern, plain, bwd in kernels:
            nbytes = sum(epilogue_bytes(s, z, bwd, c_axis)
                         for s, z in shapes)
            step_ms = time_ms(kern, sets, per_graph=49, replays=5) * 49
            plain_ms = time_ms(plain, sets, per_graph=49, replays=2) * 49
            largest = {}
            for shape, with_z in {(s, z) for s, z in shapes
                                  if np.prod(s[1:]) in (64 * 112 * 112,
                                                        256 * 56 * 56)}:
                idx = [i for i, (s, z) in enumerate(shapes)
                       if (s, z) == (shape, with_z)]
                one = [sets[i] for i in idx]
                largest[f"{list(shape)}{' z' if with_z else ''}"] = {
                    "calls_per_step": len(idx),
                    "ms": time_ms(kern, one, per_graph=max(len(one), 4),
                                  replays=5),
                    "bound_ms": epilogue_bytes(shape, with_z, bwd, c_axis)
                    / HBM_BYTES_PER_S * 1e3}
            rows[name] = {"calls": len(shapes),
                          "layout": "NHWC" if nhwc else "NCHW",
                          "ms": step_ms, "plain_ms": plain_ms,
                          "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                          "bound_by": "bytes", "bytes": nbytes,
                          "library_ms": None, "largest_shapes": largest}
            print(f"epilogue_time {name} " + json.dumps(rows[name]),
                  flush=True)
        del fwd_sets, bwd_sets, kernels
        torch.cuda.empty_cache()
    return rows


def resnet_phase(torch):
    """ResNet-50 training at the example's configuration; returns the
    epilogue kernels' launches in the run."""
    from paddle_tpu_torch.ops import bn_act as ba
    from paddle_tpu_torch.tools.train_resnet import train

    kernels = {"bn_act_apply_f32": ba.BN_ACT_APPLY,
               "bn_act_bwd_f32": ba.BN_ACT_BWD}
    warmup, steps, batch = 2, 10, 128
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    run = train(depth=50, batch=batch, image=224, classes=1000, steps=steps,
                lr=RESNET_LR, device="cuda", warmup=warmup, log_every=1,
                amp=False)
    torch.cuda.synchronize()
    launches = {n: kf.launches for n, kf in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = run["losses"]
    if not np.all(np.isfinite(losses)):
        fail(f"ResNet-50 losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"ResNet-50 loss did not fall: {losses}")
    n = 49 * (warmup + steps)
    if launches != {"bn_act_apply_f32": n, "bn_act_bwd_f32": n}:
        fail(f"ResNet-50 epilogue launches {launches}: expected {n} each "
             f"(49 chains x {warmup + steps} steps)")
    layout = "NHWC" if path_layout()[0] else "NCHW"
    plan = next(p for key, p in run["executor"]._cache.items()
                if key[0] == run["program"]._uid)
    formats = {o.attrs.get("data_format") for o in plan.ops
               if o.type == "fused_conv_bn_act"}
    if formats != {layout}:
        fail(f"ResNet-50 f32 plan: fused convs in {sorted(formats)}, the "
             f"epilogue kernels were checked and timed in {layout}")
    off = [name for name, t in run["scope"].items()
           if not (isinstance(t, torch.Tensor) and t.device.type == "cuda")]
    if off:
        fail(f"scope vars not on the card: {off[:5]}")
    print("resnet_training " + json.dumps({
        "model": "ResNet-50 f32", "batch": batch, "image": 224,
        "classes": 1000, "lr": RESNET_LR, "momentum": 0.9, "layout": layout,
        "warmup_steps": warmup, "timed_steps": steps,
        "losses": losses, "acc1": run["acc1"],
        "ms_per_step": run["ms_per_step"],
        "images_per_s": run["images_per_s"],
        "max_memory_allocated": peak,
        "launches_per_step": {k: v / (warmup + steps)
                              for k, v in launches.items()},
        "scope_tensors_on_card": len(list(run["scope"].items()))}),
        flush=True)
    del run
    torch.cuda.empty_cache()
    return launches


def resnet_card_vs_cpu(torch):
    """ResNet-50 at the oracle size (batch 4, 32x32, 100 classes) from one
    startup scope, 3 steps on the card (kernels) and on the CPU (plain
    versions)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.framework.scope import (Scope, load_numpy_state,
                                                  numpy_state)
    from paddle_tpu_torch.ops import bn_act as ba
    from paddle_tpu_torch.tools.train_resnet import build_program, make_batch

    main, startup, loss, _ = build_program(50, 32, 100, 0.01, amp=False)
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    start = Scope()
    cpu_exe.run(startup, scope=start)
    names = [n for n, _ in start.items()]
    state = numpy_state(start, names)
    img, label = make_batch(4, 32, 100)
    losses = {}
    launched = ba.BN_ACT_APPLY.launches
    for dev in ("cpu", "cuda"):
        scope = Scope()
        load_numpy_state(scope, state, dev)
        exe = fluid.Executor(fluid.CPUPlace() if dev == "cpu"
                             else fluid.CUDAPlace(0))
        losses[dev] = [float(exe.run(main, feed={"img": img, "label": label},
                                     fetch_list=[loss], scope=scope)[0])
                       for _ in range(3)]
    if ba.BN_ACT_APPLY.launches != launched + 49 * 3:
        fail("ResNet card vs CPU: the card's run did not launch the "
             "epilogue kernels")
    rel = abs(losses["cpu"][0] - losses["cuda"][0]) / abs(losses["cpu"][0])
    print("resnet_card_vs_cpu " + json.dumps({
        **losses, "step1_rel_diff": rel, "rtol": RESNET_STEP1_RTOL}),
        flush=True)
    if not np.all(np.isfinite(losses["cuda"])):
        fail(f"ResNet card vs CPU: card losses not finite {losses}")
    if not rel <= RESNET_STEP1_RTOL:
        fail(f"ResNet card vs CPU step-1 losses differ by {rel:.3e} > "
             f"{RESNET_STEP1_RTOL}")


# ==========================================================================
# the fc epilogue (kernel 9), and LeNet / word2vec static training
# ==========================================================================
MATMUL_SHAPES = (  # (name, M, K, N, acts checked)
    ("lenet-fc1", 256, 400, 120, None),
    ("lenet-fc2", 256, 120, 84, None),
    ("word2vec", 256, 128, 256, None),
    ("ragged", 1001, 517, 263, None),
    ("bert-ffn-in", 22528, 768, 3072, ("gelu",)),
)
# the four launches of one LeNet training step: each fc's forward (relu)
# and its grad's replay of the pre-activation (no act)
LENET_STEP_CALLS = (("lenet-fc1", "relu"), ("lenet-fc2", "relu"),
                    ("lenet-fc2", ""), ("lenet-fc1", ""))


def matmul_inputs(m, k, n, seed):
    """x (M, K), w (K, N) scaled as a layer's weights are, bias (N,)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(m, k, device="cuda", generator=gen),
            torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5,
            torch.randn(n, device="cuda", generator=gen))


def matmul_bound(m, k, n):
    """(bound_ms, bytes, flops): x, w and bias read once, out written
    once, f32; 2MNK operations over the f32 rate outside the tensor
    cores."""
    nbytes = 4 * (m * k + k * n + n + m * n)
    flops = 2 * m * n * k
    return (max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3,
            nbytes, flops)


def matmul_phase():
    """Kernel 9 against its plain version at every shape and act, then
    times; returns (max abs err, the LeNet step's row)."""
    import torch

    from paddle_tpu_torch.ops import matmul_epilogue as me
    from paddle_tpu_torch.ops.bn_act import ACTS, apply_act

    err = 0.0
    sets, rows = {}, {}
    for name, m, k, n, acts in MATMUL_SHAPES:
        nbytes = 4 * (m * k + k * n + n + m * n)
        count = max(2, min(200, -(-COLD_BYTES // nbytes)))
        sets[name] = [matmul_inputs(m, k, n, 100 + i) for i in range(count)]
        x, w, b = sets[name][0]
        row = {"shape": name, "M": m, "K": k, "N": n,
               "variant": me.f32_variant(m, n, k, w.data_ptr() % 16 == 0)}
        for act in acts or ACTS:
            got = me.matmul_bias_act(x, w, b, act)
            want = me.matmul_bias_act_reference(x, w, b, act)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            if not (torch.isfinite(got).all()
                    and bool((diff <= MATMUL_ATOL
                              + MATMUL_RTOL * want.abs()).all())):
                fail(f"matmul_bias_act_f32 {name} act {act!r}: max |err| "
                     f"{float(diff.max()):.3e} outside rtol {MATMUL_RTOL} "
                     f"/ atol {MATMUL_ATOL}")
            row[f"err {act or 'none'}"] = float(diff.max())
            err = max(err, float(diff.max()))
            if act == (acts or ("relu",))[0]:
                again = me.matmul_bias_act(x, w, b, act)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    fail(f"matmul_bias_act_f32 {name} act {act!r}: two "
                         f"calls differ")
                row["repeatable"] = True
                del again
            del got, want, diff
        act = (acts or ("relu",))[0]
        per_graph = max(len(sets[name]), 4)
        replays = 3 if m * n * k > 1e9 else 10
        bound_ms, nbytes, flops = matmul_bound(m, k, n)
        row.update({
            "act": act, "input_sets": len(sets[name]),
            "ms": time_ms(lambda x, w, b: me.matmul_bias_act(x, w, b, act),
                          sets[name], per_graph, replays),
            "plain_ms": time_ms(
                lambda x, w, b: me.matmul_bias_act_reference(x, w, b, act),
                sets[name], per_graph, replays),
            "bound_ms": bound_ms,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / F32_FLOP_PER_S else "operations"),
            "library_ms": time_ms(
                lambda x, w, b: apply_act(torch.addmm(b, x, w), act),
                sets[name], per_graph, replays)})
        row["tflops"] = flops / row["ms"] / 1e9
        row["bound_share"] = bound_ms / row["ms"]
        rows[name] = row
        print("matmul_case " + json.dumps(row), flush=True)
        if m * n * k > 1e9:
            del sets[name]
            torch.cuda.empty_cache()

    # one LeNet step's four launches, 64 steps' worth of inputs in turn
    # (62 MB: the L2 stays cold, as for the single shapes)
    args = [(*sets[name][i % len(sets[name])], act)
            for i in range(64) for name, act in LENET_STEP_CALLS]
    n_step = len(LENET_STEP_CALLS)
    step = {"calls_per_step": n_step,
            "bound_ms": sum(matmul_bound(rows[nm]["M"], rows[nm]["K"],
                                         rows[nm]["N"])[0]
                            for nm, _ in LENET_STEP_CALLS)}
    for key, fn in (
            ("ms", lambda x, w, b, act: me.matmul_bias_act(x, w, b, act)),
            ("plain_ms", lambda x, w, b, act:
                me.matmul_bias_act_reference(x, w, b, act)),
            ("library_ms", lambda x, w, b, act:
                apply_act(torch.addmm(b, x, w), act))):
        step[key] = time_ms(fn, args, per_graph=len(args), replays=5) \
            * n_step
    step["bound_by"] = "bytes" if all(
        rows[nm]["bound_by"] == "bytes" for nm, _ in LENET_STEP_CALLS) \
        else "operations"
    step["bound_share"] = step["bound_ms"] / step["ms"]
    step["variants"] = sorted({rows[nm]["variant"]
                               for nm, _ in LENET_STEP_CALLS})
    print("matmul_lenet_step " + json.dumps(step), flush=True)
    del sets
    torch.cuda.empty_cache()
    return err, step


def book_phase(torch, model, chains, act):
    """One book model's static training at its tool defaults; returns
    kernel 9's launches in the run."""
    from paddle_tpu_torch.ops.matmul_epilogue import MATMUL_BIAS_ACT_F32
    from paddle_tpu_torch.tools.train_book import DEFAULTS, train

    warmup, steps = 5, 30
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    MATMUL_BIAS_ACT_F32.launches = 0
    run = train(model, DEFAULTS[model], steps=steps, device="cuda",
                warmup=warmup, log_every=5)
    torch.cuda.synchronize()
    launches = MATMUL_BIAS_ACT_F32.launches
    peak = torch.cuda.max_memory_allocated()
    losses = run["losses"]
    if not np.all(np.isfinite(losses)):
        fail(f"{model} losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{model} loss did not fall: {losses}")
    plan = next(p for key, p in run["executor"]._cache.items()
                if key[0] == run["program"]._uid)
    fused = [o for o in plan.ops if o.type == "fused_matmul_bias_act"]
    grads = [o for o in plan.ops if o.type == "fused_matmul_bias_act_grad"]
    if (len(fused), len(grads)) != (chains, chains) or any(
            o.attrs["act_type"] != act for o in fused):
        fail(f"{model}: the program holds {len(fused)} fused_matmul_bias_act"
             f" ({[o.attrs['act_type'] for o in fused]}) and {len(grads)} "
             f"grads, expected {chains} each with act {act!r}")
    n = 2 * chains * (warmup + steps)
    if launches != n:
        fail(f"{model}: matmul_bias_act_f32 launched {launches} times, "
             f"expected {n} ({2 * chains} per step x {warmup + steps})")
    off = [name for name, t in run["scope"].items()
           if not (isinstance(t, torch.Tensor) and t.device.type == "cuda")]
    if off:
        fail(f"{model}: scope vars not on the card: {off[:5]}")
    cfg = DEFAULTS[model]
    print(f"{model}_training " + json.dumps({
        "model": f"{model} f32", **cfg, "warmup_steps": warmup,
        "timed_steps": steps, "losses": losses, "acc": run["acc"],
        "ms_per_step": run["ms_per_step"],
        "examples_per_s": run["examples_per_s"],
        "max_memory_allocated": peak,
        "launches_per_step": launches / (warmup + steps),
        "fused_chains": len(fused),
        "scope_tensors_on_card": len(list(run["scope"].items()))}),
        flush=True)
    del run
    torch.cuda.empty_cache()
    return launches


def lenet_card_vs_cpu(torch):
    """``bench.py:_lenet_losses`` on the card and on the CPU from one
    startup scope."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.framework.scope import (Scope, load_numpy_state,
                                                  numpy_state)
    from paddle_tpu_torch.ops.matmul_epilogue import MATMUL_BIAS_ACT_F32
    from paddle_tpu_torch.tools.train_book import build_program

    steps = 12
    main, startup, fetch = build_program("lenet", {"batch": 64, "lr": 0.05},
                                         seed=5)
    start = Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=start)
    state = numpy_state(start, [n for n, _ in start.items()])
    rng = np.random.RandomState(7)
    feed = {"img": rng.rand(64, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (64, 1)).astype(np.int64)}
    losses = {}
    launched = MATMUL_BIAS_ACT_F32.launches
    for dev in ("cpu", "cuda"):
        scope = Scope()
        load_numpy_state(scope, state, dev)
        exe = fluid.Executor(fluid.CPUPlace() if dev == "cpu"
                             else fluid.CUDAPlace(0))
        losses[dev] = [float(exe.run(main, feed=feed, fetch_list=fetch[:1],
                                     scope=scope)[0]) for _ in range(steps)]
    if MATMUL_BIAS_ACT_F32.launches != launched + 4 * steps:
        fail("LeNet card vs CPU: the card's run did not launch kernel 9 "
             "4 times per step")
    cpu, card = np.asarray(losses["cpu"]), np.asarray(losses["cuda"])
    rel1 = abs(card[0] - cpu[0]) / abs(cpu[0])
    worst = float(np.abs(card - cpu).max())
    print("lenet_card_vs_cpu " + json.dumps({
        **losses, "step1_rel_diff": rel1, "step1_rtol": LENET_STEP1_RTOL,
        "max_abs_diff": worst, "atol": LENET_LOSS_ATOL}), flush=True)
    if not np.all(np.isfinite(card)):
        fail(f"LeNet card vs CPU: card losses not finite {losses}")
    if not (rel1 <= LENET_STEP1_RTOL and worst <= LENET_LOSS_ATOL):
        fail(f"LeNet card vs CPU: step 1 {rel1:.3e} relative (tolerance "
             f"{LENET_STEP1_RTOL}), worst step {worst:.3e} absolute "
             f"(tolerance {LENET_LOSS_ATOL})")


# ==========================================================================
# static AMP in bf16: the bf16 gelu, the bf16 epilogue kernels 7-9, and
# ResNet-50 / LeNet / word2vec under decorate(optimizer)
# ==========================================================================
GELU_ROWS = (  # (kernel name, the JAX lowering it stands for: XLA-fused)
    ("gelu_fwd_bf16", "paddle_tpu/ops/math_ops.py:110"),
    ("gelu_bwd_bf16", "paddle_tpu/ops/math_ops.py:110"),
)
GELU_FP16_ROWS = tuple((name.replace("_bf16", "_fp16"), replaces)
                       for name, replaces in GELU_ROWS)
EPILOGUE_BF16_ROWS = tuple((name.replace("_f32", "_bf16"), replaces)
                           for name, replaces in EPILOGUE_ROWS)
EPILOGUE_FP16_ROWS = tuple((name.replace("_f32", "_fp16"), replaces)
                           for name, replaces in EPILOGUE_ROWS)
# the steepest slope of kernel 9's acts (exact gelu's peaks at 1.13)
MATMUL_BF16_SLOPE = 1.13
# per static AMP dtype: its kernels' name tag, the unit its errors are
# printed in ("ulps": 2^-8 relative for bf16, half of a bf16 rounding
# step at 1, as phase a counts them; 2^-11 for fp16, the same half step),
# one rounding step of a product near 1 (2^-7 and 2^-10), and the f32
# accumulators' difference kernel 9's tolerance adds, relative to
# |x| @ |w| (the K products added in two orders; it can exceed an fp16
# step of a small product: 1.5e-5 measured at K = 4099, H100; it stays
# far under a bf16 one), and, for a 16-bit bias, what the 16-bit sum's
# rounding adds relative to the output (bf16: half a step, as PR 6 held
# it; fp16: a whole step, since the two sides' products one rounding
# apart can round the sum apart: 1.33 half-steps measured at the ragged
# shape, H100)
AMP = {"bfloat16": {"tag": "bf16", "unit": 2.0 ** -8, "step": 2.0 ** -7,
                    "acc": 0.0, "sum": 2.0 ** -8},
       "float16": {"tag": "fp16", "unit": 2.0 ** -11, "step": 2.0 ** -10,
                   "acc": 2.0 ** -18, "sum": 2.0 ** -10}}
# the AMP ResNet-50 step-1 loss on the card (NHWC, cuDNN, the kernels) vs
# on the CPU (NCHW, oneDNN, the plain versions) from one startup scope:
# roundings in two summation orders through 50 layers of BN over four
# values per channel (1x1 maps) at batch 4, where the loss is chaotic:
# half a rounding step of noise (AMP_RESNET_NOISE, relative) on the
# images moves the CPU's own step-1 loss by far more (printed each run as
# cpu_noise_step1_rel; bf16: 16%).  bf16 card vs CPU measured 9.3e-3 in
# two runs (both sides deterministic): held to AMP_RESNET_STEP1_RTOL,
# twice that.  fp16 is held to the envelope itself, twice the larger
# change of two noisy CPU twins (seeds 1 and 2): card vs CPU measured
# 3.6e-2 at 2^15 in its first run (H100), where 2^-12 of image noise
# moves the CPU's own step-1 loss by 2.1% and 1.9% (this sandbox's CPU),
# so a fixed tolerance would be a guess.  After step 1 of a run that
# found no Inf every state tensor (``rel_errs``: its largest difference
# over the CPU's largest magnitude) is held, velocities (the step-1
# gradients) and the rest apart, to twice the first noisy CPU twin's
# worst and median
AMP_RESNET_NOISE = {"bfloat16": 2.0 ** -9, "float16": 2.0 ** -12}
AMP_RESNET_STEP1_RTOL = 2e-2
# fp16 ResNet-50 at the oracle size finds an Inf at every step under
# decorate's 2^15 (so does JAX's ResNet-18 there,
# tests/test_torch_static_amp_fp16.py), and on the CPU still from 1024;
# the card-vs-CPU state check runs a second time from this scale, where
# the CPU's first three steps find none
FP16_CLEAN_SCALE = 128.0
# AMP LeNet on the card vs on the CPU from one startup scope, 12 steps:
# step 1 relative, every step absolute (bf16 products in two orders; on
# the CPU JAX and the port differ by 2.1e-4 at step 1, 6.4e-3 by step 4;
# fp16: 7e-8 at step 3, and the tolerances are bf16's)
AMP_LENET_STEP1_RTOL = {"bfloat16": 2e-3, "float16": 2e-3}
AMP_LENET_LOSS_ATOL = {"bfloat16": 5e-2, "float16": 5e-2}
# the fp16 ResNet-50 main path: at least this many clean (no Inf) steps,
# running past the first 12 when some are skipped, up to FP16_MAX_STEPS
FP16_CLEAN_STEPS, FP16_MAX_STEPS = 4, 80


def same16(got, want) -> bool:
    """Bit for bit, NaN where ``want`` has NaN."""
    import torch

    nan = torch.isnan(want.float())
    return bool(torch.equal(torch.isnan(got.float()), nan)) and bool(
        torch.equal(got.view(torch.int16)[~nan], want.view(torch.int16)[~nan]))


def gelu_phase(amp_dtype="bfloat16"):
    """The bf16 (or fp16) gelu kernels: their tables (built on the card by
    the kernels' arithmetic) equal to ``gelu_table_reference`` (the plain
    ops on the CPU); the forward on all 65,536 inputs and the backward on
    every input with 4 seeded dy, and both at BERT-base's FFN shape
    (22528 x 3072) and a ragged one, bit for bit with the plain versions
    run on the CPU (JAX's values on every finite input; on the card the
    plain bf16 version's exp, CUDA's expf, is a rounding step off at x =
    -1.71875); then timed at the FFN shape against the bound, the plain
    versions on the card and ``F.gelu`` in that dtype (forward; its
    backward alone).  Returns {kernel: row}."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import gelu

    tag = FLASH_LOW[amp_dtype][0]
    dt = getattr(torch, amp_dtype)
    k_fwd = getattr(gelu, f"gelu_fwd_{tag}")
    k_bwd = getattr(gelu, f"gelu_bwd_{tag}")
    p_fwd = getattr(gelu, f"gelu_{tag}_reference")
    p_bwd = getattr(gelu, f"gelu_{tag}_grad_reference")
    fname, bname = f"gelu_fwd_{tag}", f"gelu_bwd_{tag}"
    rows = {}
    errs = {fname: 0.0, bname: 0.0}
    if not torch.equal(gelu.gelu_tables(dt, "cuda").cpu(),
                       gelu.gelu_table_reference(dt)):
        fail(f"gelu {tag}: the card's tables differ from "
             f"gelu_table_reference")
    every = torch.arange(65536, dtype=torch.int32, device="cuda").to(
        torch.int16).view(dt)
    if not same16(k_fwd(every).cpu(), p_fwd(every.cpu())):
        fail(f"{fname} differs from its plain version on the 65,536 inputs")
    xs = every.repeat(4)
    dys = torch.tensor(np.random.RandomState(22).randn(xs.numel()),
                       dtype=torch.float32, device="cuda").to(dt)
    if not same16(k_bwd(xs, dys).cpu(), p_bwd(xs.cpu(), dys.cpu())):
        fail(f"{bname} differs from its plain version on every input "
             f"with 4 dy")
    print(f"gelu_every_input_{tag} " + json.dumps({
        "forward_inputs": 65536, "backward_pairs": xs.numel(),
        "bit_equal": True, "band": list(gelu.GELU_BANDS[dt])}), flush=True)
    del every, xs, dys
    gen = torch.Generator(device="cuda").manual_seed(21)
    ffn = (22528, 3072)
    for shape in (ffn, (1001, 37)):
        x = (torch.randn(shape, device="cuda", generator=gen) * 3).to(dt)
        dy = torch.randn(shape, device="cuda", generator=gen).to(dt)
        got, gdx = k_fwd(x).cpu(), k_bwd(x, dy).cpu()
        x, dy = x.cpu(), dy.cpu()
        want, wdx = p_fwd(x), p_bwd(x, dy)
        fwd = float((got.float() - want.float()).abs().max())
        bwd = float((gdx.float() - wdx.float()).abs().max())
        errs[fname] = max(errs[fname], fwd)
        errs[bname] = max(errs[bname], bwd)
        if not (torch.equal(got, want) and torch.equal(gdx, wdx)):
            fail(f"gelu {tag} kernels differ from their plain versions at "
                 f"{shape}: forward {fwd}, backward {bwd}")
        del x, dy, got, gdx, want, wdx
    n = ffn[0] * ffn[1]
    count = max(2, -(-COLD_BYTES // (4 * n)))
    sets = [((torch.randn(ffn, device="cuda", generator=gen) * 3).to(dt),
             torch.randn(ffn, device="cuda", generator=gen).to(dt))
            for _ in range(count)]

    def lib_bwd(x, dy):
        return torch.ops.aten.gelu_backward(dy, x)

    # the same bytes moved by one PyTorch call without the arithmetic (a
    # copy for the forward, an add for the backward): the streaming rate
    # the card reaches for this shape
    for name, kern, plain, lib, copy, nbytes in (
            (fname, lambda x, dy: k_fwd(x), lambda x, dy: p_fwd(x),
             lambda x, dy: F.gelu(x), lambda x, dy: x.clone(), 4 * n),
            (bname, k_bwd, p_bwd, lib_bwd, lambda x, dy: x + dy, 6 * n)):
        rows[name] = {"shape": list(ffn), "max_abs_err": errs[name],
                      "ms": time_ms(kern, sets, 8, 5),
                      "plain_ms": time_ms(plain, sets, 4, 2),
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bound_by": "bytes",
                      "library_ms": time_ms(lib, sets, 8, 5),
                      "copy_ms": time_ms(copy, sets, 8, 5)}
        print(f"gelu_time {name} " + json.dumps(rows[name]), flush=True)
    del sets
    torch.cuda.empty_cache()
    return rows


def epilogue_low_inputs(shape, with_z, seed, c_axis, dt):
    """x (and z) and the per-channel vectors in ``dt``, an f32 c0."""
    x, z, (a, b, mean, cx) = epilogue_inputs(shape, with_z, seed, c_axis)
    low = [t.to(dt) if t is not None else None for t in (x, z, a, b, mean,
                                                          cx)]
    return low, b.clone()


def epilogue_low_bytes(shape, with_z, bwd, c):
    """Bytes each 16-bit call must move: data at 2 bytes an element; the
    per-channel vectors at 2 (a, b; cg, mean, cx) and 4 (c0)."""
    n = int(np.prod(shape))
    if bwd:
        return 2 * n * (4 + with_z) + (2 * 3 + 4) * c
    return 2 * n * (2 + with_z) + 2 * 2 * c


def check_epilogue_low(amp_dtype):
    """Kernels 7 and 8 in ``amp_dtype`` against their plain versions: bit
    for bit for "" and relu and the backward (with and without z / g),
    within one unit (AMP) of the largest output for sigmoid, tanh and
    gelu, at a ragged shape in both layouts and a channels-last (M, C)
    case; then at each of the 49 shapes of the AMP ResNet-50 step, NCHW
    and NHWC, with relu, z where the chain has one and g on the residual
    chains.  Returns ({kernel: max err}, the input sets in the main
    path's layout (from its plan) for the timing, that layout)."""
    import torch

    from paddle_tpu_torch.ops import bn_act as ba

    dt, tag, unit = getattr(torch, amp_dtype), AMP[amp_dtype]["tag"], \
        AMP[amp_dtype]["unit"]
    fwd_name, bwd_name = f"bn_act_apply_{tag}", f"bn_act_bwd_{tag}"
    errs = {fwd_name: 0.0, bwd_name: 0.0}

    def one(name, shape, c_axis, with_z, acts, seed):
        (x, z, a, b, mean, cx), c0 = epilogue_low_inputs(shape, with_z, seed,
                                                         c_axis, dt)
        for act in acts:
            for zz in ((None, z) if with_z else (None,)):
                got = ba.bn_act_apply(x, a, b, zz, act, c_axis)
                want = ba.bn_act_apply_reference(x, a, b, zz, act, c_axis)
                torch.cuda.synchronize()
                if got.dtype != dt:
                    fail(f"{fwd_name} {name}: output {got.dtype}")
                err = ulps_off(got, want, unit)
                if ((act in ("", "relu") and not torch.equal(got, want))
                        or err > 1.0):
                    fail(f"{fwd_name} {name} act {act!r} z "
                         f"{zz is not None}: {err:.2f} {tag} units off")
                errs[fwd_name] = max(errs[fwd_name], float(
                    (got.float() - want.float()).abs().max()))
        y = torch.relu(x)
        dy = z if z is not None else x
        for act in ("", "relu"):
            for want_g in (False, True):
                dx, g = ba.bn_act_bwd_apply(y, dy, x, a, mean, cx, c0, act,
                                            c_axis, want_g)
                rdx, rg = ba.bn_act_bwd_reference(y, dy, x, a, mean, cx, c0,
                                                  act, c_axis, want_g)
                torch.cuda.synchronize()
                err = bwd_err(dx, g, rdx, rg)
                if (dx.dtype != dt or not torch.equal(dx, rdx)
                        or (want_g and not torch.equal(g, rg))):
                    fail(f"{bwd_name} {name} act {act!r} want_g {want_g}: "
                         f"not equal to the plain version (max |err| "
                         f"{err:.3e})")
                errs[bwd_name] = max(errs[bwd_name], err)
        return x, z, a, b, mean, cx, c0

    for name, shape, c_axis, with_z in (
            ("ragged-nchw", (3, 37, 13, 11), 1, True),
            ("ragged-nhwc", (3, 13, 11, 37), 3, True),
            ("channels-last-mc", (4096, 64), 1, True)):
        one(name, shape, c_axis, with_z, tuple(ba.ACTS), 31)
        print(f"epilogue_check_{tag} " + json.dumps(
            {"case": name, "shape": list(shape), "c_axis": c_axis,
             "acts": list(ba.ACTS), "bit_exact": ["", "relu", "bwd"]}),
            flush=True)
    path_nhwc, _ = path_layout(amp_dtype)
    path_sets = None
    for nhwc in (False, True):
        layout, c_axis = ("NHWC", 3) if nhwc else ("NCHW", 1)
        shapes = resnet50_epilogue_shapes(amp_dtype, nhwc)
        if len(shapes) != 49:
            fail(f"the {tag} AMP ResNet-50 program ({layout}) has "
                 f"{len(shapes)} fused conv chains, expected 49")
        sets = []
        for i, (shape, with_z) in enumerate(shapes):
            t = one(f"path {layout} {shape}", shape, c_axis, with_z,
                    ("relu",), 200 + i)
            sets.append((shape, with_z, t))
        print(f"epilogue_check_{tag} " + json.dumps(
            {"case": f"ResNet-50 {tag} AMP path, {layout}", "shapes": 49,
             "bit_exact": True}), flush=True)
        if nhwc == path_nhwc:
            path_sets = sets
        else:
            del sets
    torch.cuda.empty_cache()
    return errs, path_sets, ("NHWC" if path_nhwc else "NCHW")


def time_epilogue_low(amp_dtype, sets, layout):
    """Both 16-bit kernels timed over the 49 calls of one AMP ResNet-50
    step in the main path's layout, every call on its own tensors, by
    CUDA-graph replay, against their plain versions and the byte bound.
    Returns {kernel: row}."""
    import torch

    from paddle_tpu_torch.ops import bn_act as ba

    tag = AMP[amp_dtype]["tag"]
    c_axis = 3 if layout == "NHWC" else 1
    fwd = [(x, a, b, z) for _, _, (x, z, a, b, mean, cx, c0) in sets]
    bwd = [(torch.relu(x), torch.randn_like(x), x, a, mean, cx, c0,
            z is not None) for _, _, (x, z, a, b, mean, cx, c0) in sets]
    rows = {}
    for name, args, kern, plain, is_bwd in (
            (f"bn_act_apply_{tag}", fwd,
             lambda x, a, b, z: ba.bn_act_apply(x, a, b, z, "relu", c_axis),
             lambda x, a, b, z: ba.bn_act_apply_reference(
                 x, a, b, z, "relu", c_axis), False),
            (f"bn_act_bwd_{tag}", bwd,
             lambda y, dy, x, cg, m, cx, c0, wg: ba.bn_act_bwd_apply(
                 y, dy, x, cg, m, cx, c0, "relu", c_axis, wg),
             lambda y, dy, x, cg, m, cx, c0, wg: ba.bn_act_bwd_reference(
                 y, dy, x, cg, m, cx, c0, "relu", c_axis, wg), True)):
        nbytes = sum(epilogue_low_bytes(shape, z, is_bwd, shape[c_axis])
                     for shape, z, _ in sets)
        rows[name] = {"calls": len(sets), "layout": layout,
                      "ms": time_ms(kern, args, per_graph=49, replays=5) * 49,
                      "plain_ms": time_ms(plain, args, per_graph=49,
                                          replays=2) * 49,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bound_by": "bytes", "bytes": nbytes,
                      "library_ms": None}
        print(f"epilogue_time {name} " + json.dumps(rows[name]), flush=True)
    torch.cuda.empty_cache()
    return rows


# kernel 9's tile edges in bf16 / fp16 (M, K, N): around the 64- and
# 128-row tiles, the 64-deep stages and the 128- and 256-wide column
# tiles, with K and N multiples of 8 so that every variant takes them,
# a K of 72 (a ragged second stage), and one all-odd shape (cp.async only)
MATMUL_LOW_EDGES = ((127, 128, 136), (129, 136, 128), (255, 256, 264),
                    (257, 248, 256), (200, 72, 136), (255, 257, 263))


def matmul_low_bound(m, k, n, low_out=False):
    """(bound_ms, bytes, flops): 16-bit x and w, f32 bias and output (or,
    ``low_out``, 16-bit ones), read or written once; 2MNK operations at
    the bf16 / fp16 tensor-core peak (the same 989 TFLOP/s)."""
    nbytes = 2 * (m * k + k * n) + (2 if low_out else 4) * (n + m * n)
    flops = 2 * m * n * k
    return (max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3,
            nbytes, flops)


def matmul_low_phase(amp_dtype):
    """Kernel 9 in ``amp_dtype`` against its plain version (the AMP
    program's unfused chain: the product rounded to the 16-bit type, the
    f32 bias added, the act in f32) at every shape and act: the products
    are summed in another order, so a product may round the other way:
    every output within one rounding step of its product times the act's
    largest slope (MATMUL_BF16_SLOPE x step x |x @ w|), plus f32 noise,
    and the share of outputs not bit-equal reported.  A 16-bit bias (a
    16-bit output) once.  Then times against the bound, the plain version
    and ``torch.addmm`` in that type plus the act; the four calls of one
    AMP LeNet step together.  Returns (max abs err, the LeNet step's row,
    the BERT FFN row)."""
    import torch

    from paddle_tpu_torch.ops import matmul_epilogue as me
    from paddle_tpu_torch.ops.bn_act import ACTS, apply_act

    dt, tag = getattr(torch, amp_dtype), AMP[amp_dtype]["tag"]
    unit, step_ulp = AMP[amp_dtype]["unit"], AMP[amp_dtype]["step"]
    kname = f"matmul_bias_act_{tag}"

    def low_set(m, k, n, seed):
        x, w, b = matmul_inputs(m, k, n, seed)
        return x.to(dt), w.to(dt), b, b.to(dt)

    err = 0.0
    # the tile edges: each variant that takes the shape, gelu (the
    # steepest act), both bias dtypes; the variant tc_variant picks with
    # every act
    for m, k, n in MATMUL_LOW_EDGES:
        x, w, b, b16 = low_set(m, k, n, 290)
        signed = x.float() @ w.float()
        prod = signed.abs()
        pre = (signed + b16.float()).abs()
        prod_tol = step_ulp * prod
        if AMP[amp_dtype]["acc"]:
            prod_tol += AMP[amp_dtype]["acc"] * (x.float().abs()
                                                 @ w.float().abs())
        picked = me.tc_variant(m, n, k)
        worst = 0.0
        for variant in me.TC_VARIANTS:
            if variant != "cp.async 64x64" and (k % 8 or n % 8):
                continue
            for act in (ACTS if variant == picked else ("gelu",)):
                for bias in (b, b16):
                    got = getattr(me, kname)(x, w, bias, act, variant)
                    want = me.matmul_bias_act_reference(x, w, bias, act)
                    torch.cuda.synchronize()
                    bound = (MATMUL_BF16_SLOPE * prod_tol
                             + 1e-6 * want.float().abs() + 1e-7)
                    if bias is b16:
                        # the 16-bit sum's rounding, as the card tests
                        # hold it (tests/test_torch_cuda_kernels.py)
                        bound = bound + (
                            2.0 ** -8 * want.float().abs() if tag == "bf16"
                            else MATMUL_BF16_SLOPE * 2.0 ** -10 * pre
                            + 2.0 ** -11 * want.float().abs())
                    diff = (got.float() - want.float()).abs()
                    if got.dtype != bias.dtype or not (
                            torch.isfinite(got).all()
                            and bool((diff <= bound).all())):
                        fail(f"{kname} ({variant}) at {m}x{k}x{n} act "
                             f"{act!r}, {bias.dtype} bias: "
                             f"{ulps_off(got, want, unit):.2f} units off")
                    worst = max(worst, ulps_off(got, want, unit))
                    err = max(err, float(diff.max()))
        print(f"matmul_edge_{tag} " + json.dumps({
            "M": m, "K": k, "N": n, "picked": picked,
            "variants": [v for v in me.TC_VARIANTS if v == "cp.async 64x64"
                         or not (k % 8 or n % 8)],
            "worst_units": worst}), flush=True)
    sets, rows = {}, {}
    for name, m, k, n, acts in MATMUL_SHAPES:
        nbytes = matmul_low_bound(m, k, n)[1]
        count = max(2, min(200, -(-COLD_BYTES // nbytes)))
        sets[name] = [low_set(m, k, n, 300 + i) for i in range(count)]
        x, w, b, b16 = sets[name][0]
        row = {"shape": name, "M": m, "K": k, "N": n}
        prod = (x.float() @ w.float()).abs()     # TF32 off: full f32
        prod_tol = step_ulp * prod
        if AMP[amp_dtype]["acc"]:
            prod_tol += AMP[amp_dtype]["acc"] * (x.float().abs()
                                                 @ w.float().abs())
        for act in acts or ACTS:
            got = me.matmul_bias_act(x, w, b, act)
            want = me.matmul_bias_act_reference(x, w, b, act)
            torch.cuda.synchronize()
            if got.dtype != torch.float32:
                fail(f"{kname} {name}: output {got.dtype}")
            off = ulps_off(got, want, unit)
            bound = (MATMUL_BF16_SLOPE * prod_tol
                     + 1e-6 * want.abs() + 1e-7)
            if not (torch.isfinite(got).all()
                    and bool(((got - want).abs() <= bound).all())):
                fail(f"{kname} {name} act {act!r}: an output beyond one "
                     f"{tag} rounding of its product ({off:.2f} units of "
                     f"the largest output)")
            row[f"ulps {act or 'none'}"] = off
            row[f"unequal {act or 'none'}"] = float(
                (got != want).float().mean())
            err = max(err, float((got - want).abs().max()))
            del got, want
        got = me.matmul_bias_act(x, w, b16, "relu")
        want = me.matmul_bias_act_reference(x, w, b16, "relu")
        torch.cuda.synchronize()
        # one rounding of the product, and the 16-bit sum's own rounding
        bound = prod_tol + AMP[amp_dtype]["sum"] * want.float().abs()
        if got.dtype != dt or not bool(
                ((got.float() - want.float()).abs() <= bound).all()):
            fail(f"{kname} {name} with a {tag} bias: {got.dtype}, "
                 f"{ulps_off(got, want, unit):.2f} units off")
        del prod, prod_tol
        act = (acts or ("relu",))[0]
        per_graph = max(len(sets[name]), 4)
        replays = 3 if m * n * k > 1e9 else 10
        bound_ms, nbytes, flops = matmul_low_bound(m, k, n)
        row.update({
            "act": act, "input_sets": len(sets[name]),
            "ms": time_ms(lambda x, w, b, b16: me.matmul_bias_act(
                x, w, b, act), sets[name], per_graph, replays),
            "plain_ms": time_ms(
                lambda x, w, b, b16: me.matmul_bias_act_reference(
                    x, w, b, act), sets[name], per_graph, replays),
            "bound_ms": bound_ms,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / BF16_FLOP_PER_S else "operations"),
            "library_ms": time_ms(
                lambda x, w, b, b16: apply_act(torch.addmm(b16, x, w), act),
                sets[name], per_graph, replays)})
        row["tflops"] = flops / row["ms"] / 1e9
        row["bound_share"] = bound_ms / row["ms"]
        row["variant"] = me.tc_variant(m, n, k)
        rows[name] = row
        print(f"matmul_case_{tag} " + json.dumps(row), flush=True)
        if m * n * k > 1e9:
            # the same product with a 16-bit bias: a 16-bit output, the
            # bytes addmm writes
            bound16, nbytes16, _ = matmul_low_bound(m, k, n, low_out=True)
            row16 = {"shape": name, "M": m, "K": k, "N": n, "bias": tag,
                     "act": act, "input_sets": len(sets[name]),
                     "ms": time_ms(lambda x, w, b, b16: me.matmul_bias_act(
                         x, w, b16, act), sets[name], per_graph, replays),
                     "plain_ms": time_ms(
                         lambda x, w, b, b16: me.matmul_bias_act_reference(
                             x, w, b16, act), sets[name], per_graph,
                         replays),
                     "bound_ms": bound16,
                     "bound_by": ("bytes" if nbytes16 / HBM_BYTES_PER_S
                                  >= flops / BF16_FLOP_PER_S
                                  else "operations"),
                     "library_ms": row["library_ms"]}
            row16["tflops"] = flops / row16["ms"] / 1e9
            row16["bound_share"] = bound16 / row16["ms"]
            print(f"matmul_case_{tag} " + json.dumps(row16), flush=True)
            del sets[name]
            torch.cuda.empty_cache()
    args = [(*sets[name][i % len(sets[name])], act)
            for i in range(64) for name, act in LENET_STEP_CALLS]
    n_step = len(LENET_STEP_CALLS)
    step = {"calls_per_step": n_step,
            "bound_ms": sum(matmul_low_bound(rows[nm]["M"], rows[nm]["K"],
                                             rows[nm]["N"])[0]
                            for nm, _ in LENET_STEP_CALLS)}
    for key, fn in (
            ("ms", lambda x, w, b, b16, act: me.matmul_bias_act(x, w, b,
                                                                act)),
            ("plain_ms", lambda x, w, b, b16, act:
                me.matmul_bias_act_reference(x, w, b, act)),
            ("library_ms", lambda x, w, b, b16, act:
                apply_act(torch.addmm(b16, x, w), act))):
        step[key] = time_ms(fn, args, per_graph=len(args), replays=5) \
            * n_step
    step["bound_by"] = "bytes" if all(
        rows[nm]["bound_by"] == "bytes" for nm, _ in LENET_STEP_CALLS) \
        else "operations"
    print(f"matmul_lenet_step_{tag} " + json.dumps(step), flush=True)
    del sets
    torch.cuda.empty_cache()
    return err, step, rows["bert-ffn-in"]


def epilogue_kernels():
    """{name: KernelFunction} of kernels 7 and 8 in every dtype."""
    from paddle_tpu_torch.ops import bn_act as ba

    return {"bn_act_apply_f32": ba.BN_ACT_APPLY,
            "bn_act_bwd_f32": ba.BN_ACT_BWD,
            "bn_act_apply_bf16": ba.BN_ACT_APPLY_BF16,
            "bn_act_bwd_bf16": ba.BN_ACT_BWD_BF16,
            "bn_act_apply_fp16": ba.BN_ACT_APPLY_FP16,
            "bn_act_bwd_fp16": ba.BN_ACT_BWD_FP16}


def more_clean_steps(run, max_steps):
    """Run a dynamic-loss-scaling :func:`train` result on until
    FP16_CLEAN_STEPS of its steps found no Inf, or ``max_steps`` steps in
    all; its losses, found-Inf flags and scales grow in place."""
    while (sum(not f for f in run["found_inf"]) < FP16_CLEAN_STEPS
           and len(run["losses"]) < max_steps):
        out = run["executor"].run(run["program"], feed=run["feed"],
                                  fetch_list=run["fetch"],
                                  scope=run["scope"])
        run["losses"].append(float(out[0]))
        run["acc1"].append(float(out[1]))
        run["loss_scaling"].append(float(out[2][0]))
        run["found_inf"].append(bool(out[3][0]))
        print(f"step {len(run['losses']) - 1}: loss {run['losses'][-1]:.4f}"
              f" scale {run['loss_scaling'][-1]:g} found_inf "
              f"{run['found_inf'][-1]}", flush=True)


def resnet_amp_phase(torch, amp_dtype):
    """ResNet-50 under ``decorate(MomentumOptimizer)`` in ``amp_dtype``,
    NHWC by ``FLAGS_cuda_nhwc=auto``: 2 warm-up and 10 timed steps; every
    loss finite and the last below the first (fp16: over the steps that
    found no Inf, running on past the twelfth until FP16_CLEAN_STEPS of
    them are clean), each epilogue kernel of the dtype launched 49 times
    per step and no other one, the convolutions' Input channels-last.
    fp16 also prints the found-Inf steps, the scale after each step, and
    a profile of 2 more steps (idle share, kernels and ops per step).
    Returns the dtype's epilogue kernels' launches."""
    from paddle_tpu_torch.tools.train_resnet import profile_steps, train

    tag = AMP[amp_dtype]["tag"]
    kernels = epilogue_kernels()
    warmup, steps, batch = 2, 10, 128
    gc.collect()   # the step is host-bound: no collection of earlier phases
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    run = train(depth=50, batch=batch, image=224, classes=1000, steps=steps,
                lr=RESNET_LR, device="cuda", warmup=warmup, log_every=1,
                amp=True, amp_dtype=amp_dtype)
    scaled = "found_inf" in run
    if scaled:
        more_clean_steps(run, FP16_MAX_STEPS)
    torch.cuda.synchronize()
    launches = {n: kf.launches for n, kf in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = run["losses"]
    n_steps = len(losses)
    clean = ([i for i, f in enumerate(run["found_inf"]) if not f]
             if scaled else list(range(n_steps)))
    if not np.all(np.isfinite(losses)):
        fail(f"ResNet-50 AMP {tag} losses not finite: {losses}")
    if len(clean) < (FP16_CLEAN_STEPS if scaled else 2):
        fail(f"ResNet-50 AMP {tag}: {len(clean)} clean steps of {n_steps}")
    if not losses[clean[-1]] < losses[clean[0]]:
        fail(f"ResNet-50 AMP {tag} loss did not fall over the clean steps "
             f"{clean}: {losses}")
    want = {k: (49 * n_steps if k.endswith(tag) else 0) for k in kernels}
    if launches != want:
        fail(f"ResNet-50 AMP {tag} epilogue launches {launches}: expected "
             f"{want}")
    plan = next(p for key, p in run["executor"]._cache.items()
                if key[0] == run["program"]._uid)
    types = [o.type for o in plan.ops]
    fused = [o for o in plan.ops if o.type == "fused_conv_bn_act"]
    if (len(fused) != 49 or any(o.attrs.get("data_format") != "NHWC"
                                for o in fused)
            or "cast" not in types or "transpose2" not in types):
        fail(f"ResNet-50 AMP {tag} plan: {len(fused)} fused convs, formats "
             f"{sorted({o.attrs.get('data_format') for o in fused})}, "
             f"casts {types.count('cast')}, transposes "
             f"{types.count('transpose2')}")
    report = {
        "model": f"ResNet-50 AMP {tag} (decorate"
                 f"{', use_fp16=True' if scaled else ''})",
        "batch": batch, "image": 224, "classes": 1000, "lr": RESNET_LR,
        "momentum": 0.9, "layout": "NHWC", "warmup_steps": warmup,
        "timed_steps": steps, "steps": n_steps, "losses": losses,
        "acc1": run["acc1"], "ms_per_step": run["ms_per_step"],
        "images_per_s": run["images_per_s"],
        "max_memory_allocated": peak,
        "launches_per_step": {k: v / n_steps for k, v in launches.items()},
        "casts": types.count("cast"), "transposes": types.count("transpose2"),
        "ops": len(types)}
    if scaled:
        report.update(
            found_inf_steps=[i for i, f in enumerate(run["found_inf"]) if f],
            clean_steps=clean, loss_scaling=run["loss_scaling"])
        prof = profile_steps(run, 2)
        report["profile"] = {k: prof[k] for k in (
            "wall_ms_per_step", "device_busy_ms_per_step",
            "device_idle_share", "kernels_per_step")}
        report["profile"]["ops_per_step"] = len(types)
    print(f"resnet_training_amp_{tag} " + json.dumps(report), flush=True)
    del run
    torch.cuda.empty_cache()
    return {k: v for k, v in launches.items() if k.endswith(tag)}


def rel_errs(got, want):
    """Per tensor: largest |got - want| over the largest |want|."""
    return {n: float(np.abs(got[n] - w).max())
            / max(float(np.abs(w).max()), 1e-12) for n, w in want.items()}


def resnet_amp_card_vs_cpu(torch, amp_dtype, init_loss_scaling=None):
    """The AMP ResNet-50 step at the oracle size (batch 4, 32x32, 100
    classes) in ``amp_dtype`` from one startup scope, 3 steps on the card
    (NHWC, kernels) and on the CPU (NCHW, plain versions): every step
    finite; step 1 within AMP_RESNET_STEP1_RTOL (bf16) or, under loss
    scaling (fp16), within twice the step-1 change of two CPU twins on
    images carrying half a rounding step of noise; under loss scaling
    the found-Inf flags and the scale after each step equal; and, when
    step 1 found no Inf, the state after step 1 (parameters, velocities,
    BN statistics) within the envelope of the first twin.  Returns
    whether step 1 was clean."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.framework.scope import (Scope, load_numpy_state,
                                                  numpy_state)
    from paddle_tpu_torch.tools.train_resnet import (build_program,
                                                     loss_scaling_state,
                                                     make_batch)

    tag = AMP[amp_dtype]["tag"]
    kf = epilogue_kernels()[f"bn_act_apply_{tag}"]
    main, startup, loss, _ = build_program(
        50, 32, 100, 0.01, amp=True, amp_dtype=amp_dtype,
        init_loss_scaling=init_loss_scaling)
    scaling = list(loss_scaling_state(main) or ())
    start = Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=start)
    names = [n for n, _ in start.items()]
    state = numpy_state(start, names)
    img, label = make_batch(4, 32, 100)
    losses, history, after1 = {}, {}, {}
    launched = kf.launches
    for dev in ("cpu", "cuda"):
        scope = Scope()
        load_numpy_state(scope, state, dev)
        exe = fluid.Executor(fluid.CPUPlace() if dev == "cpu"
                             else fluid.CUDAPlace(0))
        losses[dev], history[dev] = [], []
        for step in range(3):
            out = exe.run(main, feed={"img": img, "label": label},
                          fetch_list=[loss] + scaling, scope=scope)
            losses[dev].append(float(out[0]))
            if scaling:
                history[dev].append([float(out[1][0]), bool(out[2][0])])
            if step == 0:
                after1[dev] = numpy_state(scope, names)
    if kf.launches != launched + 49 * 3:
        fail(f"ResNet AMP {tag} card vs CPU: the card's run did not launch "
             f"the {tag} epilogue kernels")
    clean1 = not (scaling and history["cpu"][0][1])
    cpu1 = losses["cpu"][0]

    def twin(seed):
        """(step-1 loss change, scope) of the CPU on noisy images."""
        scope = Scope()
        load_numpy_state(scope, state, "cpu")
        noisy = img * (1 + AMP_RESNET_NOISE[amp_dtype]
                       * np.random.RandomState(seed).randn(*img.shape))
        got = float(fluid.Executor(fluid.CPUPlace()).run(
            main, feed={"img": noisy.astype(np.float32), "label": label},
            fetch_list=[loss], scope=scope)[0])
        return abs(got - cpu1) / abs(cpu1), scope

    twins = [twin(seed) for seed in ((1, 2) if scaling else
                                     (1,) if clean1 else ())]
    rtol = (2 * max(t for t, _ in twins) if scaling
            else AMP_RESNET_STEP1_RTOL)
    rel = abs(cpu1 - losses["cuda"][0]) / abs(cpu1)
    report = {**losses, "init_loss_scaling": init_loss_scaling,
              "history": history, "step1_rel_diff": rel, "rtol": rtol,
              "cpu_noise_step1_rel": [t for t, _ in twins]}
    groups = {}
    if clean1:
        scope = twins[0][1]
        keep = [n for n in names if "loss_scaling" not in n]
        errs = rel_errs({n: after1["cuda"][n] for n in keep},
                        {n: after1["cpu"][n] for n in keep})
        env = rel_errs({n: numpy_state(scope, keep)[n] for n in keep},
                       {n: after1["cpu"][n] for n in keep})
        for gname, pick in (("velocities", lambda n: "velocity" in n),
                            ("other_state", lambda n: "velocity" not in n)):
            got = [e for n, e in errs.items() if pick(n)]
            ref = [e for n, e in env.items() if pick(n)]
            groups[gname] = {"tensors": len(got), "worst": max(got),
                             "median": float(np.median(got)),
                             "twin_worst": max(ref),
                             "twin_median": float(np.median(ref))}
        report["after_step1"] = groups
    print(f"resnet_amp_card_vs_cpu_{tag} " + json.dumps(report), flush=True)
    if not np.all(np.isfinite(losses["cuda"])):
        fail(f"ResNet AMP {tag} card vs CPU: card losses not finite "
             f"{losses}")
    if history["cuda"] != history["cpu"]:
        fail(f"ResNet AMP {tag} card vs CPU: found-Inf / scale history "
             f"{history['cuda']} on the card, {history['cpu']} on the CPU")
    if not rel <= rtol:
        fail(f"ResNet AMP {tag} card vs CPU step-1 losses differ by "
             f"{rel:.3e} > {rtol:.3e}")
    for gname, g in groups.items():
        if not (g["worst"] <= 2 * g["twin_worst"]
                and g["median"] <= 2 * g["twin_median"]):
            fail(f"ResNet AMP {tag} card vs CPU after step 1, {gname}: {g} "
                 f"outside twice the noisy twin's envelope")
    return clean1


def book_amp_phase(torch, model, chains, act, amp_dtype):
    """One book model under ``decorate`` in ``amp_dtype`` at its tool
    defaults, 5 warm-up and 30 timed steps: losses finite and falling,
    the chains fused, kernel 9 of the dtype launched 2 x chains per step
    and no other kernel 9; fp16: no step finds an Inf.  Returns the
    dtype's kernel 9 launches."""
    from paddle_tpu_torch.ops.matmul_epilogue import (MATMUL_BIAS_ACT_BF16,
                                                      MATMUL_BIAS_ACT_F32,
                                                      MATMUL_BIAS_ACT_FP16)
    from paddle_tpu_torch.tools.train_book import DEFAULTS, train

    tag = AMP[amp_dtype]["tag"]
    kernels = {"f32": MATMUL_BIAS_ACT_F32, "bf16": MATMUL_BIAS_ACT_BF16,
               "fp16": MATMUL_BIAS_ACT_FP16}
    warmup, steps = 5, 30
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    run = train(model, DEFAULTS[model], steps=steps, device="cuda",
                warmup=warmup, log_every=5, amp=True, amp_dtype=amp_dtype)
    torch.cuda.synchronize()
    launches = {k: kf.launches for k, kf in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = run["losses"]
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{model} AMP {tag} losses {losses} not finite or not falling")
    if any(run.get("found_inf", ())):
        fail(f"{model} AMP {tag}: steps found an Inf: {run['found_inf']}")
    plan = next(p for key, p in run["executor"]._cache.items()
                if key[0] == run["program"]._uid)
    fused = [o for o in plan.ops if o.type == "fused_matmul_bias_act"]
    grads = [o for o in plan.ops if o.type == "fused_matmul_bias_act_grad"]
    if (len(fused), len(grads)) != (chains, chains) or any(
            o.attrs["act_type"] != act for o in fused):
        fail(f"{model} AMP {tag}: {len(fused)} fused_matmul_bias_act and "
             f"{len(grads)} grads, expected {chains} each with act {act!r}")
    n = 2 * chains * (warmup + steps)
    want = {k: (n if k == tag else 0) for k in kernels}
    if launches != want:
        fail(f"{model} AMP {tag}: kernel 9 launches {launches}, expected "
             f"{want}")
    report = {
        "model": f"{model} AMP {tag} (decorate)", **DEFAULTS[model],
        "warmup_steps": warmup, "timed_steps": steps, "losses": losses,
        "acc": run["acc"], "ms_per_step": run["ms_per_step"],
        "examples_per_s": run["examples_per_s"],
        "max_memory_allocated": peak,
        "launches_per_step": launches[tag] / (warmup + steps),
        "fused_chains": len(fused)}
    if "loss_scaling" in run:
        report["loss_scaling_last"] = run["loss_scaling"][-1]
    print(f"{model}_training_amp_{tag} " + json.dumps(report), flush=True)
    del run
    torch.cuda.empty_cache()
    return launches[tag]


def lenet_amp_card_vs_cpu(torch, amp_dtype):
    """``bench.py:_lenet_losses``'s run under ``decorate`` in
    ``amp_dtype`` on the card and on the CPU from one startup scope, 12
    steps; fp16: the found-Inf flags and the scale equal at every
    step."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.framework.scope import (Scope, load_numpy_state,
                                                  numpy_state)
    from paddle_tpu_torch.ops import matmul_epilogue as me
    from paddle_tpu_torch.tools.train_book import build_program
    from paddle_tpu_torch.tools.train_resnet import loss_scaling_state

    tag = AMP[amp_dtype]["tag"]
    kf = getattr(me, f"MATMUL_BIAS_ACT_{tag.upper()}")
    steps = 12
    main, startup, fetch = build_program("lenet", {"batch": 64, "lr": 0.05},
                                         seed=5, amp=True,
                                         amp_dtype=amp_dtype)
    scaling = list(loss_scaling_state(main) or ())
    start = Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=start)
    state = numpy_state(start, [n for n, _ in start.items()])
    rng = np.random.RandomState(7)
    feed = {"img": rng.rand(64, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (64, 1)).astype(np.int64)}
    losses, history = {}, {}
    launched = kf.launches
    for dev in ("cpu", "cuda"):
        scope = Scope()
        load_numpy_state(scope, state, dev)
        exe = fluid.Executor(fluid.CPUPlace() if dev == "cpu"
                             else fluid.CUDAPlace(0))
        outs = [exe.run(main, feed=feed, fetch_list=fetch[:1] + scaling,
                        scope=scope) for _ in range(steps)]
        losses[dev] = [float(o[0]) for o in outs]
        history[dev] = [[float(o[1][0]), bool(o[2][0])] for o in outs
                        if scaling]
    if kf.launches != launched + 4 * steps:
        fail(f"LeNet AMP {tag} card vs CPU: the card's run did not launch "
             f"the {tag} kernel 9 4 times per step")
    cpu, card = np.asarray(losses["cpu"]), np.asarray(losses["cuda"])
    rel1 = abs(card[0] - cpu[0]) / abs(cpu[0])
    worst = float(np.abs(card - cpu).max())
    rtol, atol = AMP_LENET_STEP1_RTOL[amp_dtype], AMP_LENET_LOSS_ATOL[
        amp_dtype]
    print(f"lenet_amp_card_vs_cpu_{tag} " + json.dumps({
        **losses, "history": history, "step1_rel_diff": rel1,
        "step1_rtol": rtol, "max_abs_diff": worst, "atol": atol}),
        flush=True)
    if not np.all(np.isfinite(card)):
        fail(f"LeNet AMP {tag} card vs CPU: card losses not finite {losses}")
    if history["cuda"] != history["cpu"]:
        fail(f"LeNet AMP {tag} card vs CPU: found-Inf / scale history "
             f"differs: {history}")
    if not (rel1 <= rtol and worst <= atol):
        fail(f"LeNet AMP {tag} card vs CPU: step 1 {rel1:.3e} relative "
             f"(tolerance {rtol}), worst step {worst:.3e} absolute "
             f"(tolerance {atol})")


# ==========================================================================
# quantized KV serving: kernel 6 over bf16 and int8 pages, the prefix cache
# and chunked prefill
# ==========================================================================
QUANT_ROWS = (  # (pool dtype, kernel name)
    ("bfloat16", "paged_decode_bf16"), ("int8", "paged_decode_int8"))
# a quantized engine's token stream may part from another run's (cold vs
# prefix-cache hit or chunked; card vs CPU) only where the reference's
# top-2 logit margin is below TIE_FACTOR times the dtype's logit error,
# measured in the same run (its decode logits against the f32
# full-recompute reference's over a probe request)
TIE_FACTOR = 4.0
# int8 scales on the card vs on the CPU: layer 0's are the absmax of K/V
# rows that cuBLAS and oneDNN compute an ulp or so apart
# (tests/test_torch_kv_quant.py); a later layer's K/V also carry every
# earlier layer's codes that rounded the other way, each one int8 step
# (1/127 of its scale) in what the attention read, so they are held to
# one int8 step relative
SCALE_RTOL = 1e-5
SCALE_RTOL_DEEP = 1.0 / 127


def token_share(a, b):
    """Share of generated tokens equal position by position."""
    same = sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb))
    return same / max(1, sum(len(r) for r in a))


def first_divergence(core, prompt, want, got, tie, what):
    """None when the two token lists agree; else the first position
    they part at, which must fall where the f32 reference's top-2 logit
    margin is below ``tie``."""
    import torch

    if want == got:
        return None
    i = next((j for j, (x, y) in enumerate(zip(want, got)) if x != y),
             min(len(want), len(got)))
    top2 = torch.topk(core.reference_logits(list(prompt) + want[:i]),
                      2).values
    margin = float(top2[0] - top2[1])
    if margin >= tie:
        fail(f"{what}: token {i} parts with top-2 margin {margin:.3e} >= "
             f"{tie:.3e}")
    return {"first_divergence": i, "top2_margin": margin}


def logit_error(eng, prompt, n_new):
    """The largest |logit| difference between a quantized engine's decode
    steps for one request and the f32 full-recompute reference at the
    same positions: the dtype's logit error."""
    from paddle_tpu_torch.inference.serving import Request

    core = eng.core
    seen = []
    decode = core.model.decode

    def capture(*a, **kw):
        out = decode(*a, **kw)
        seen.append(out[0].clone())
        return out

    core.model.decode = capture
    req = Request("probe", list(prompt), n_new)
    eng.submit(req)
    eng.run_to_completion()
    del core.model.decode
    err = 0.0
    for j, logits in enumerate(seen):
        ref = core.reference_logits(list(prompt) + req.out_tokens[:j + 1])
        err = max(err, float((logits - ref).abs().max()))
    return err


def shared_prefix_trace(vocab):
    """8 requests sharing a 256-token prefix, suffixes of 32-128 tokens."""
    rng = np.random.RandomState(7)
    prefix = rng.randint(0, vocab, size=256).tolist()
    return [prefix + rng.randint(0, vocab, size=int(n)).tolist()
            for n in rng.randint(32, 129, size=8)]


def prefix_chunk_phase(torch):
    """Per quantized dtype, the shared-prefix trace cold, with the prefix
    cache, and with 64-token chunks; the latter two must give the cold
    run's tokens, or part from them only at a near-tie."""
    from paddle_tpu_torch.inference.serving import (
        DecoderConfig, Request, ServingEngine, init_decoder_weights)

    cfg = DecoderConfig(**GPT2_SMALL)
    weights = init_decoder_weights(cfg, 0)
    prompts = shared_prefix_trace(cfg.vocab_size)
    ties = {}
    for dtype, kname in QUANT_ROWS:
        kernel = decode_kernels()[dtype]

        def engine(**kw):
            return ServingEngine(cfg, weights, page_size=16, max_batch=8,
                                 token_budget=1024, device="cuda",
                                 kv_dtype=dtype, kv_budget_mb=KV_BUDGET_MB,
                                 **kw)

        eng = engine()
        err = logit_error(eng, prompts[0], 16)
        tie = TIE_FACTOR * err
        ties[dtype] = tie
        del eng
        runs = {}
        for label, kw in (("cold", {}), ("prefix_cache", dict(
                prefix_cache=True)), ("chunk64", dict(prefill_chunk=64))):
            eng = engine(**kw)
            reqs = [Request(i, list(p), 32) for i, p in enumerate(prompts)]
            torch.cuda.synchronize()
            kernel.launches = 0
            t0 = time.perf_counter()
            for r in reqs:
                eng.submit(r)
            eng.run_to_completion()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = eng.kv.stats()["prefix_cache"]
            runs[label] = {
                "tokens": [r.out_tokens for r in reqs], "wall_s": wall,
                "prefill_tokens": eng.stats["prefill_tokens"],
                "prefill_hit_tokens": eng.stats["prefill_hit_tokens"],
                "prefill_chunks": eng.stats["prefill_chunks"],
                "forked_pages": st["forked_pages"],
                "decode_steps": eng.stats["decode_steps"],
                f"{kname}_launches": kernel.launches}
            if kernel.launches != cfg.num_layers * eng.stats["decode_steps"]:
                fail(f"{dtype} {label}: {kname} launches {kernel.launches}"
                     f" != layers x decode steps")
            core = eng.core
            del eng
        if runs["prefix_cache"]["prefill_hit_tokens"] <= 0:
            fail(f"{dtype}: the prefix cache served no hit")
        if runs["chunk64"]["prefill_chunks"] <= len(prompts):
            fail(f"{dtype}: chunked prefill did not chunk")
        cold = runs["cold"]["tokens"]
        report = {"kv_dtype": dtype, "logit_error": err, "tie_margin": tie,
                  "runs": {k: {kk: vv for kk, vv in v.items()
                               if kk != "tokens"} for k, v in runs.items()}}
        for label in ("prefix_cache", "chunk64"):
            got = runs[label]["tokens"]
            report["runs"][label]["equal_to_cold"] = got == cold
            report["runs"][label]["divergences"] = [
                d for d in (first_divergence(core, p, w, g, tie,
                                             f"{dtype} {label} req {i}")
                            for i, (p, w, g) in enumerate(zip(prompts, cold,
                                                              got)))
                if d is not None]
        print("prefix_chunk " + json.dumps(report), flush=True)
        del core
        gc.collect()
        torch.cuda.empty_cache()
    return ties


def quant_card_vs_cpu(torch, ties):
    """2 layers at GPT-2-small width, the same weights and trace on the
    card (the kernels) and on the CPU (the plain versions), bf16 and
    int8 pools, once with the prefix cache (request 0's prompt is the
    40-token shared prefix, so the others fork its partial page) and
    once with 32-token chunks: equal event streams, or a first parting
    at a near-tie; the int8 codes within 1 and the scales as
    ``int8_pools_close`` holds them."""
    from paddle_tpu_torch.inference.serving import (
        DecoderConfig, Request, ServingEngine, init_decoder_weights)

    cfg = DecoderConfig(**{**GPT2_SMALL, "num_layers": 2})
    weights = init_decoder_weights(cfg, 0)
    rng = np.random.RandomState(3)
    prefix = rng.randint(0, cfg.vocab_size, size=40).tolist()
    prompts = [list(prefix)] + [
        prefix + rng.randint(0, cfg.vocab_size, size=int(n)).tolist()
        for n in (3, 70, 150)]
    for dtype, _ in QUANT_ROWS:
        for label, kw in (("prefix_cache", dict(prefix_cache=True)),
                          ("chunk32", dict(prefill_chunk=32))):
            out = {}
            for dev in ("cuda", "cpu"):
                eng = ServingEngine(cfg, weights, num_pages=64, page_size=16,
                                    max_batch=4, token_budget=512,
                                    device=dev, kv_dtype=dtype, **kw)
                reqs = [Request(i, list(p), 16)
                        for i, p in enumerate(prompts)]
                for r in reqs:
                    eng.submit(r)
                events, t = [], 0.0
                while eng.has_work():
                    t += 1.0
                    events.extend(eng.step(t))
                out[dev] = (eng, events, [r.out_tokens for r in reqs])
            card, cpu = out["cuda"], out["cpu"]
            row = {"kv_dtype": dtype, "run": label,
                   "events_equal": card[1] == cpu[1],
                   "tie_margin": ties[dtype],
                   "prefill_hit_tokens": card[0].stats["prefill_hit_tokens"],
                   "prefill_chunks": card[0].stats["prefill_chunks"],
                   "forked_pages": card[0].kv.stats()["prefix_cache"]
                   ["forked_pages"]}
            row["divergences"] = [
                d for d in (first_divergence(
                    cpu[0].core, p, w, g, ties[dtype],
                    f"{dtype} {label} card vs CPU req {i}")
                    for i, (p, w, g) in enumerate(zip(prompts, cpu[2],
                                                      card[2])))
                if d is not None]
            if card[1] == cpu[1] and dtype == "int8":
                (row["int8_codes_one_step_off"],
                 row["int8_scale_rel_err_by_layer"]) = int8_pools_close(
                    card[0].core, cpu[0].core)
            print("quant_card_vs_cpu " + json.dumps(row), flush=True)
            del out, card, cpu
            gc.collect()
            torch.cuda.empty_cache()


def int8_pools_close(card, cpu):
    """The card's int8 pools within one code of the CPU's, its layer-0
    scales within SCALE_RTOL and the others within SCALE_RTOL_DEEP;
    returns the share of codes one step off and each layer's largest
    relative scale difference."""
    off = total = 0
    rels = []
    for layer, ((kc, vc), (kp, vp), sc, sp) in enumerate(zip(
            card.kv_pools, cpu.kv_pools, card.kv_scales, cpu.kv_scales)):
        for a, b in ((kc, kp), (vc, vp)):
            diff = (a.cpu().int() - b.int()).abs()
            if int(diff.max()) > 1:
                fail(f"int8 card vs CPU: a code {int(diff.max())} steps off")
            off += int((diff > 0).sum())
            total += diff.numel()
        rel = max(float(((a.cpu() - b).abs()
                         / b.abs().clamp_min(1e-30)).max())
                  for a, b in zip(sc, sp))
        tol = SCALE_RTOL if layer == 0 else SCALE_RTOL_DEEP
        if rel > tol:
            fail(f"int8 card vs CPU: layer {layer}'s scales {rel:.3e} "
                 f"apart > {tol:.3e}")
        rels.append(rel)
    return off / total, rels


# ==========================================================================
# head dims that are no tile width
# ==========================================================================
# flash: (dtype, d) at b 4, h 8, s 640 (ten kv tiles, the last ragged);
# paged decode: every pool dtype at these head dims (40 and 120 take the
# int8 kernel's 8-byte slices, 96 and 160 its 16-byte ones)
FLASH_HEAD_DIMS = (("float32", 40), ("float32", 96), ("float32", 120),
                   ("bfloat16", 96), ("float16", 96))
PAGED_HEAD_DIMS = (40, 96, 120, 160)


def head_dim_phase():
    """Phase z: the flash kernels (forward, fused and split backward) and
    the paged decode kernels at head dims the JAX kernels take and no
    tile width equals, each against its plain version on the same CUDA
    tensors (the f32 flash kernels within KERNEL_ATOL and the gradient
    tolerance, bf16 / fp16 within their ulps; the paged kernels within
    KERNEL_ATOL)."""
    import torch

    from paddle_tpu_torch.ops import paged_attention as pa

    for amp_dtype, d in FLASH_HEAD_DIMS:
        case = make_flash_case(40 + d, 4, 8, 640, d, True)
        for causal, rate in ((False, 0.1), (True, 0.0)):
            if amp_dtype == "float32":
                check_flash(f"d{d}", case, causal, rate)
            else:
                check_flash_low(f"d{d}", low_case(case, amp_dtype), causal,
                                rate, amp_dtype)
        del case
    torch.cuda.empty_cache()
    rng = np.random.RandomState(1)
    lens = [1, 16, 33, 250, 777]
    for d in PAGED_HEAD_DIMS:
        errs = {}
        case = make_decode_case(rng, 8, 2, d, 16, 256, lens, n_pad=1)
        got = pa.paged_decode(*case, d ** -0.5)
        want = pa.paged_attention_reference(*case, d ** -0.5)
        errs["paged_decode_f32"] = float((got - want).abs().max())
        for dtype, kname in QUANT_ROWS:
            c, sc = make_paged_case(rng, dtype, 8, 2, d, 16, 256, lens, 1)
            kernel = getattr(pa, kname)
            got = kernel(*c, d ** -0.5, *sc)
            want = pa.paged_attention_reference(*c, d ** -0.5, *sc)
            if not torch.isfinite(got).all():
                fail(f"{kname} at head dim {d}: output not finite")
            errs[kname] = float((got - want).abs().max())
        torch.cuda.synchronize()
        print("head_dim_paged " + json.dumps({"d": d, **errs}), flush=True)
        if max(errs.values()) > KERNEL_ATOL:
            fail(f"paged decode at head dim {d}: {errs} > {KERNEL_ATOL}")


# ==========================================================================
# serving completeness (phase 9b): sampled and speculative decoding, static
# batching, slo_aware admission, telemetry and request tracing
# ==========================================================================
#: phase 9b's sampled decoding (top-k 50 then the 0.95 nucleus)
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
#: drafted tokens a speculative step (the n-gram proposer)
SPEC_K = 4


def phase9_prompts(vocab):
    """``serve()``'s 16 prompts (32-512 tokens, numpy seed 0)."""
    rng = np.random.RandomState(0)
    lens = rng.randint(32, 513, size=16)
    return [rng.randint(0, vocab, size=int(n)).tolist() for n in lens]


def self_similar_prompts(vocab):
    """16 prompts of 32-512 tokens from ``loadgen.poisson_trace`` with
    ``repeat_frac=0.5``: half of each prompt copies spans of its start,
    which the n-gram proposer drafts from."""
    from paddle_tpu_torch.utils.loadgen import poisson_trace

    return [e.prompt for e in poisson_trace(
        16, 100.0, vocab, prompt_len_range=(32, 512),
        max_new_range=(64, 64), seed=0, repeat_frac=0.5)]


def run_trace(torch, eng, prompts, max_new=64):
    """Serve ``prompts`` to the end on ``eng`` (a ``ServingEngine`` or
    ``StaticBatchingEngine``): tokens, wall seconds, the decode (or
    verify) calls and their wall ms per call, and kernel 6's launches."""
    from paddle_tpu_torch.inference.serving import Request

    core = eng.core
    name = "verify_batch" if getattr(eng, "spec_k", 0) else "decode_batch"
    fn = getattr(core, name)
    wall = {"calls": 0, "s": 0.0}

    def timed(*a):
        t = time.perf_counter()
        out = fn(*a)            # ends in a host read of the tokens
        wall["s"] += time.perf_counter() - t
        wall["calls"] += 1
        return out

    setattr(core, name, timed)
    kernel = decode_kernels()[core.kv_dtype]
    reqs = [Request(i, list(p), max_new) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    kernel.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    delattr(core, name)
    if any(r.finished_at is None for r in reqs):
        fail(f"{type(eng).__name__}: a request did not finish")
    tokens = [r.out_tokens for r in reqs]
    n_tok = sum(len(t) for t in tokens)
    return {"tokens": tokens, "wall_s": elapsed,
            "tokens_per_s": n_tok / elapsed, "generated_tokens": n_tok,
            "calls": wall["calls"],
            "ms_per_call": wall["s"] / max(wall["calls"], 1) * 1e3,
            "launches": kernel.launches, "reqs": reqs}


def check_divergences(core, prompts, want, got, tie, what):
    """``first_divergence`` of each request; the rows where one parts."""
    return [d for d in (first_divergence(core, p, w, g, tie,
                                         f"{what} req {i}")
                        for i, (p, w, g) in enumerate(zip(prompts, want,
                                                          got)))
            if d is not None]


def serving_completeness_phase(torch, f32_tokens, ties):
    """Sampled decoding captured and replayed bit for bit, kernel 6
    launched layers x steps; greedy speculative decoding equal to plain
    decoding up to near-ties, on f32 and int8 pools; the static-batching
    engine equal to the continuous one; ``slo_aware`` above ``fifo`` on
    the overload bench's quick trace; telemetry and tracing on giving the
    same streams, with spans that reconcile with the counters."""
    from paddle_tpu_torch.inference.serving import (
        DecoderConfig, SamplingParams, ServingEngine, StaticBatchingEngine,
        init_decoder_weights)
    from paddle_tpu_torch.tools import overload_bench
    from paddle_tpu_torch.utils import flags, telemetry, tracing

    t_phase = time.perf_counter()
    cfg = DecoderConfig(**GPT2_SMALL)
    weights = init_decoder_weights(cfg, 0)
    prompts = phase9_prompts(cfg.vocab_size)
    flags.set_flags({"FLAGS_cuda_step_session": "1"})

    def engine(kv_dtype="float32", **kw):
        pool = dict(num_pages=1024) if kv_dtype == "float32" else \
            dict(kv_budget_mb=KV_BUDGET_MB)
        return ServingEngine(cfg, weights, page_size=16, max_batch=8,
                             token_budget=1024, device="cuda",
                             kv_dtype=kv_dtype, **pool, **kw)

    def strip(run):
        return {k: v for k, v in run.items() if k not in ("tokens", "reqs")}

    # -- sampled decoding -------------------------------------------------
    sp = SamplingParams(**SAMPLED)
    greedy = run_trace(torch, engine(), prompts)
    sampled = [run_trace(torch, engine(sampling=sp), prompts)
               for _ in range(2)]
    flags.set_flags({"FLAGS_cuda_step_session": "0"})
    eager = run_trace(torch, engine(sampling=sp), prompts)
    flags.set_flags({"FLAGS_cuda_step_session": "1"})
    top1 = run_trace(torch, engine(sampling=SamplingParams(
        temperature=0.8, top_k=1)), prompts)
    steps = sampled[0]["calls"]
    report = {"sampling": SAMPLED, "runs": {
        "greedy_captured": strip(greedy),
        "sampled_captured": strip(sampled[0]),
        "sampled_captured_again": strip(sampled[1]),
        "sampled_eager": strip(eager), "top_k_1_captured": strip(top1)}}
    report["sampled_replay_bit_identical"] = \
        sampled[0]["tokens"] == sampled[1]["tokens"]
    report["captured_equals_eager"] = \
        sampled[0]["tokens"] == eager["tokens"]
    report["top_k_1_equals_phase9_greedy"] = top1["tokens"] == f32_tokens
    report["greedy_captured_equals_phase9"] = greedy["tokens"] == f32_tokens
    report["sampled_share_equal_to_greedy"] = token_share(
        sampled[0]["tokens"], greedy["tokens"])
    report["decode_ms_per_step"] = {"sampled": sampled[0]["ms_per_call"],
                                    "greedy": greedy["ms_per_call"]}
    print("serving_sampled " + json.dumps(report), flush=True)
    if not report["sampled_replay_bit_identical"]:
        fail("sampled decoding: two fresh engines with one seed differ")
    if not report["captured_equals_eager"]:
        fail("sampled decoding: the captured steps differ from eager ones")
    if not report["top_k_1_equals_phase9_greedy"]:
        fail("top_k=1 sampling differs from phase 9's greedy streams")
    if sampled[0]["tokens"] == greedy["tokens"]:
        fail("sampled decoding gave the greedy streams: the sampler did "
             "not engage")
    for run in (greedy, sampled[0], top1):
        if run["launches"] != cfg.num_layers * run["calls"]:
            fail(f"kernel 6 launches {run['launches']} != layers "
                 f"{cfg.num_layers} x decode steps {run['calls']}")

    # -- static batching ---------------------------------------------------
    static = run_trace(torch, StaticBatchingEngine(engine().core, 8),
                       prompts)
    row = {"static_tokens_per_s": static["tokens_per_s"],
           "continuous_tokens_per_s": greedy["tokens_per_s"],
           "static_decode_steps": static["calls"],
           "continuous_decode_steps": greedy["calls"],
           "static_wall_s": static["wall_s"],
           "continuous_wall_s": greedy["wall_s"],
           "tokens_equal": static["tokens"] == greedy["tokens"],
           "tie_margin": TIE_MARGIN}
    ref_core = engine().core
    row["divergences"] = check_divergences(
        ref_core, prompts, greedy["tokens"], static["tokens"], TIE_MARGIN,
        "static vs continuous")
    print("serving_static " + json.dumps(row), flush=True)

    # -- speculative decoding ----------------------------------------------
    spec_prompts = self_similar_prompts(cfg.vocab_size)
    for kv_dtype in ("float32", "int8"):
        plain = run_trace(torch, engine(kv_dtype), spec_prompts)
        eng = engine(kv_dtype, spec_k=SPEC_K, proposer="ngram")
        spec = run_trace(torch, eng, spec_prompts)
        # an int8 page keeps the scale its rejected drafts raised (as the
        # JAX package's pools do), so the codes after it differ from plain
        # decoding's by up to an int8 step: phase n's quantized tie holds
        tie = TIE_MARGIN if kv_dtype == "float32" else \
            max(TIE_MARGIN, ties["int8"])
        row = {"kv_dtype": kv_dtype, "spec_k": SPEC_K,
               "proposed": eng.stats["spec_proposed"],
               "accepted": eng.stats["spec_accepted"],
               "verify_calls": spec["calls"],
               "plain_decode_steps": plain["calls"],
               "verify_ms_per_call": spec["ms_per_call"],
               "plain_decode_ms_per_step": plain["ms_per_call"],
               "tokens_per_s_spec": spec["tokens_per_s"],
               "tokens_per_s_plain": plain["tokens_per_s"],
               "kernel6_launches_spec": spec["launches"],
               "tokens_equal": spec["tokens"] == plain["tokens"],
               "tie_margin": tie}
        row["divergences"] = check_divergences(
            ref_core, spec_prompts, plain["tokens"], spec["tokens"], tie,
            f"{kv_dtype} spec vs plain")
        print("serving_spec " + json.dumps(row), flush=True)
        del eng
    del ref_core
    gc.collect()
    torch.cuda.empty_cache()

    # -- admission: the overload bench's quick trace on the card ----------
    payload, ok = overload_bench.run(["--quick", "--json", "--device",
                                      "cuda"])
    flags.set_flags({"FLAGS_chaos": "", "FLAGS_trace_requests": False})
    comp = payload["comparison"]
    hung = {f"{tag}:{p}": r["outcomes"]["hung"]
            for tag, sec in (("plain", payload),
                             ("prefix", payload["prefix_trace"]),
                             ("kv", payload["kv_quant"]))
            for p, r in sec["policies"].items()}
    print("serving_overload " + json.dumps({
        "ok": ok, "comparison": comp, "hung": hung,
        "shed": {p: r["outcomes"]["shed"]
                 for p, r in payload["policies"].items()},
        "kv_quant": payload["kv_quant"]["comparison"]}), flush=True)
    if not ok or not comp["slo_aware_strictly_better"] or any(
            hung.values()):
        fail(f"overload bench on the card: ok={ok}, {comp}, hung {hung}")

    # -- telemetry and tracing on against off, in turns -------------------
    turns = []
    for on in (False, True, True, False):
        flags.set_flags({"FLAGS_telemetry": on, "FLAGS_trace_requests": on})
        telemetry.registry().clear()
        tracing.reset()
        eng = engine()
        run = run_trace(torch, eng, prompts)
        turns.append((on, run))
        if on:
            traces = tracing.store().finished_traces()
            snap = telemetry.snapshot()
            count = {n: snap[n]["series"][0]["value"] for n in (
                "serving_admitted_total", "serving_finished_total",
                "serving_decode_steps_total")}
            spans = {
                "prefill": sum(len(t.spans_named("prefill"))
                               for t in traces),
                "finished": len(traces),
                "decode_step": sum(len(t.spans_named("decode_step"))
                                   for t in traces)}
            want = {"prefill": eng.stats["admitted"],
                    "finished": eng.stats["finished"],
                    "decode_step": eng.stats["decode_tokens"]}
            if spans != want or count != {
                    "serving_admitted_total": eng.stats["admitted"],
                    "serving_finished_total": eng.stats["finished"],
                    "serving_decode_steps_total":
                        eng.stats["decode_steps"]}:
                fail(f"spans {spans} / counters {count} do not reconcile "
                     f"with the engine's stats {eng.stats}")
        del eng
    flags.set_flags({"FLAGS_telemetry": True,
                     "FLAGS_trace_requests": False})
    telemetry.registry().clear()
    tracing.reset()
    off = [r for on, r in turns if not on]
    on = [r for on_, r in turns if on_]
    if any(r["tokens"] != greedy["tokens"] for _, r in turns):
        fail("telemetry / tracing on changed the token streams")
    print("serving_telemetry " + json.dumps({
        "wall_s_off": [r["wall_s"] for r in off],
        "wall_s_on": [r["wall_s"] for r in on],
        "decode_ms_per_step_off": [r["ms_per_call"] for r in off],
        "decode_ms_per_step_on": [r["ms_per_call"] for r in on],
        "wall_overhead_on_vs_off": sum(r["wall_s"] for r in on)
        / sum(r["wall_s"] for r in off) - 1.0,
        "streams_equal": True}), flush=True)
    flags.set_flags({"FLAGS_cuda_step_session": "0"})
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serving_completeness_seconds "
          f"{time.perf_counter() - t_phase:.1f}", flush=True)
    return sampled[0]["launches"], steps


# ==========================================================================
# the compiled step: static steps and the decode step as CUDA graphs
# ==========================================================================
#: the decode check's model: GPT-2 small's widths, depth cut to 4 layers
DECODE_CHECK = dict(GPT2_SMALL, num_layers=4)
#: steps a session turn times, and steps it then traces for busy time
# ==========================================================================
# MobileNetV3 static training (phase 16a): kernels 7-9 on its path
# ==========================================================================
# MobileNetV3-large at the PaddleClas ImageNet size; the recipe's rate is
# train_mobilenet.RECIPE's (0.05, at which the loss falls on the repeated
# batch), its warm-up and cosine computed in the program
MOBILENET = dict(scale="large", batch=128, image=224, classes=1000)
# launches per step: kernels 7 and 8 once for each relu bottleneck's
# expand and depthwise chain (6 x 2), kernel 9 twice for each
# squeeze-excite block's first fc (8: its forward, and its grad's replay
# of the pre-activation, as in LeNet)
MOBILENET_PER_STEP = {"bn_act_apply": 12, "bn_act_bwd": 12,
                      "matmul_bias_act": 16}
# the f32 step-1 loss at the test size (small, batch 4, 32x32, 10
# classes) on the card vs on the CPU port: the forward alone, cuDNN's and
# oneDNN's f32 sums in other orders
MOBILENET_STEP1_RTOL = 1e-5
MOBILENET_STEPS, MOBILENET_TURN_STEPS = 6, 3


def mobilenet_kernels():
    """{name: KernelFunction} of kernels 7-9 in every dtype."""
    from paddle_tpu_torch.ops import matmul_epilogue as me

    out = epilogue_kernels()
    out.update({"matmul_bias_act_f32": me.MATMUL_BIAS_ACT_F32,
                "matmul_bias_act_bf16": me.MATMUL_BIAS_ACT_BF16,
                "matmul_bias_act_fp16": me.MATMUL_BIAS_ACT_FP16})
    return out


def nhwc_turns(torch, step, steps):
    """Wall and busy ms per step of ``step`` with ``FLAGS_cuda_nhwc`` 0
    and 1 in turns (0, 1, 1, 0) and the compiled step on: each turn warms
    up (the first steps of a layout build its plan and capture its
    graph), times ``steps`` steps and traces 1."""
    from paddle_tpu_torch.tools.step_timing import device_busy_ms
    from paddle_tpu_torch.utils import flags

    prev = {n: flags.get_flag(n) for n in ("FLAGS_cuda_step_session",
                                           "FLAGS_cuda_nhwc")}
    rows = []
    try:
        flags.set_flags({"FLAGS_cuda_step_session": "1"})
        for value in ("0", "1", "1", "0"):
            flags.set_flags({"FLAGS_cuda_nhwc": value})
            for _ in range(2):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps * 1e3
            rows.append({"nhwc": value, "wall_ms": wall,
                         "busy_ms": device_busy_ms(step, 1)})
    finally:
        flags.set_flags(prev)
    return rows


def mobilenet_run(torch, amp_dtype=None):
    """MobileNetV3-large (``MOBILENET``) in f32 or under ``decorate`` in
    ``amp_dtype``: 2 + MOBILENET_STEPS steps op by op (fp16: on until
    FP16_CLEAN_STEPS are clean); every loss finite and the last below the
    first over the clean steps; kernels 7-9 of the dtype launched
    MOBILENET_PER_STEP times a step and no other one; the plan's fused
    convs (half of them depthwise) and fcs; then a profile of 1 step
    (wall and busy ms, the idle share, device ms of the convolutions, the
    epilogue kernels, the BN reductions and the copies, and of each op
    type's kernels) with the compiled step off and on in turns, 1 step a
    turn.  Returns the
    ``mobilenet_training_<tag>`` report and the run."""
    from paddle_tpu_torch.tools.train_mobilenet import train
    from paddle_tpu_torch.tools.train_resnet import profile_steps

    t0 = time.perf_counter()
    tag = AMP[amp_dtype]["tag"] if amp_dtype else "f32"
    kernels = mobilenet_kernels()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    run = train(**MOBILENET, steps=MOBILENET_STEPS, device="cuda", warmup=2,
                log_every=0, amp=amp_dtype is not None,
                amp_dtype=amp_dtype or "bfloat16")
    scaled = "found_inf" in run
    if scaled:
        more_clean_steps(run, FP16_MAX_STEPS)
    torch.cuda.synchronize()
    launches = {n: kf.launches for n, kf in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = run["losses"]
    n_steps = len(losses)
    clean = ([i for i, f in enumerate(run["found_inf"]) if not f]
             if scaled else list(range(n_steps)))
    what = f"MobileNetV3-large {tag}"
    if not np.all(np.isfinite(losses)):
        fail(f"{what} losses not finite: {losses}")
    if len(clean) < 2 or not losses[clean[-1]] < losses[clean[0]]:
        fail(f"{what}: the loss did not fall over the clean steps {clean}: "
             f"{losses}")
    want = {k: (MOBILENET_PER_STEP[k.rsplit("_", 1)[0]] * n_steps
                if k.endswith("_" + tag) else 0) for k in kernels}
    if launches != want:
        fail(f"{what} kernel launches {launches}: expected {want}")
    plan = next(p for key, p in run["executor"]._cache.items()
                if key[0] == run["program"]._uid)
    types = [o.type for o in plan.ops]
    fused = [o for o in plan.ops if o.type == "fused_conv_bn_act"]
    n_dw = sum(bool(o.attrs.get("depthwise")) for o in fused)
    if (len(fused), n_dw, types.count("fused_matmul_bias_act")) != \
            (12, 6, 8):
        fail(f"{what} plan: {len(fused)} fused convs ({n_dw} depthwise), "
             f"{types.count('fused_matmul_bias_act')} fused fcs")
    prof = profile_steps(run, 1)
    report = {
        "model": what + (" (decorate" + (", use_fp16=True)" if scaled
                                         else ")") if amp_dtype else ""),
        **MOBILENET, "recipe": "Momentum 0.9, L2Decay(2e-5), "
        "linear_lr_warmup(cosine_decay(0.05, 10, 120), 2, 0, 0.05)",
        "layout": ("NHWC" if fused[0].attrs.get("data_format") == "NHWC"
                   else "NCHW"),
        "steps": n_steps, "losses": losses, "acc1": run["acc1"],
        "ms_per_step": run["ms_per_step"],
        "images_per_s": run["images_per_s"],
        "max_memory_allocated": peak,
        "launches_per_step": {k: v / n_steps for k, v in launches.items()
                              if v},
        "ops": len(types), "casts": types.count("cast"),
        "transposes": types.count("transpose2"),
        "profile": {k: prof[k] for k in (
            "wall_ms_per_step", "device_busy_ms_per_step",
            "device_idle_share", "kernels_per_step", "conv_ms_per_step",
            "bn_act_apply_ms_per_step", "bn_act_bwd_ms_per_step",
            "bn_reduce_ms_per_step", "copy_ms_per_step",
            "other_ms_per_step")},
        "op_type_device_ms_per_step": prof["op_type_device_ms_per_step"],
        "step_session": prof["step_session"],
        "seconds": time.perf_counter() - t0}
    if scaled:
        report.update(
            found_inf_steps=[i for i, f in enumerate(run["found_inf"]) if f],
            loss_scaling=run["loss_scaling"])
    print(f"mobilenet_training_{tag} " + json.dumps(report), flush=True)
    return report, run


def mobilenet_card_vs_cpu(torch):
    """MobileNetV3-small f32 at the test size (batch 4, 32x32, 10 classes)
    from one startup scope, 3 steps on the card (kernels) and on the CPU
    port (plain ops): step 1 within MOBILENET_STEP1_RTOL, every step
    finite."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.framework.scope import (Scope, load_numpy_state,
                                                  numpy_state)
    from paddle_tpu_torch.tools.train_mobilenet import build_program
    from paddle_tpu_torch.tools.train_resnet import make_batch

    main, startup, loss, _ = build_program("small", 32, 10, amp=False)
    start = Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=start)
    state = numpy_state(start, [n for n, _ in start.items()])
    img, label = make_batch(4, 32, 10)
    losses = {}
    for dev in ("cpu", "cuda"):
        scope = Scope()
        load_numpy_state(scope, state, dev)
        exe = fluid.Executor(fluid.CPUPlace() if dev == "cpu"
                             else fluid.CUDAPlace(0))
        losses[dev] = [float(exe.run(main, feed={"img": img, "label": label},
                                     fetch_list=[loss], scope=scope)[0])
                       for _ in range(3)]
    rel = abs(losses["cpu"][0] - losses["cuda"][0]) / abs(losses["cpu"][0])
    print("mobilenet_card_vs_cpu " + json.dumps({
        **losses, "step1_rel_diff": rel, "rtol": MOBILENET_STEP1_RTOL}),
        flush=True)
    if not np.all(np.isfinite(losses["cuda"])):
        fail(f"MobileNet card vs CPU: card losses not finite {losses}")
    if not rel <= MOBILENET_STEP1_RTOL:
        fail(f"MobileNet card vs CPU step-1 losses differ by {rel:.3e} > "
             f"{MOBILENET_STEP1_RTOL}")


def mobilenet_phase(torch):
    """Phase 16a: MobileNetV3-large in f32 (NCHW), bf16 and fp16 under
    ``decorate`` (NHWC by auto), each checked, profiled and timed with the
    compiled step off and on (:func:`mobilenet_run`); the bf16 step with
    NHWC 0 and 1 in turns, captured; 5 bf16 steps at full size captured
    and eager, bit for bit, the rate and its counter among them; the
    small model card vs CPU.  Returns the launches per step by dtype."""
    from paddle_tpu_torch.tools import check_step_capture as csc

    out = {}
    for amp_dtype in (None, "bfloat16", "float16"):
        report, run = mobilenet_run(torch, amp_dtype)
        out[report["model"]] = report["launches_per_step"]
        if amp_dtype == "bfloat16":
            exe, prog, feed, scope, fetch = (
                run["executor"], run["program"], run["feed"], run["scope"],
                run["fetch"])
            t = time.perf_counter()
            rows = nhwc_turns(torch, lambda: exe.run(
                prog, feed=feed, fetch_list=fetch, scope=scope),
                MOBILENET_TURN_STEPS)
            rows.append({"seconds": time.perf_counter() - t})
            print("mobilenet_nhwc_turns_bf16 " + json.dumps(rows),
                  flush=True)
        del run
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    row = csc.compare_static("mobilenet-bf16", steps=5, **MOBILENET)
    row["seconds"] = time.perf_counter() - t
    print("mobilenet_step_capture " + json.dumps(row), flush=True)
    if not row["ok"]:
        fail(f"MobileNetV3-large bf16: captured steps differ from eager "
             f"ones: {row}")
    gc.collect()
    torch.cuda.empty_cache()
    mobilenet_card_vs_cpu(torch)
    return out


TURN_STEPS = {"resnet50_amp_bf16": 3, "lenet_f32": 10, "lenet_amp_bf16": 10,
              "word2vec_f32": 10, "decode": 6}
TRACED_STEPS = {"resnet50_amp_bf16": 1, "lenet_f32": 3, "lenet_amp_bf16": 3,
                "word2vec_f32": 3, "decode": 2}


def step_kernels():
    """{name: KernelFunction} of the kernels the compiled step's timed
    paths launch: kernels 7-8 in bf16 (AMP ResNet-50), kernel 9 in f32
    and bf16 (LeNet, word2vec), the paged decode over each page dtype."""
    from paddle_tpu_torch.ops import bn_act as ba
    from paddle_tpu_torch.ops import matmul_epilogue as me

    out = {"bn_act_apply_bf16": ba.BN_ACT_APPLY_BF16,
           "bn_act_bwd_bf16": ba.BN_ACT_BWD_BF16,
           "matmul_bias_act_f32": me.MATMUL_BIAS_ACT_F32,
           "matmul_bias_act_bf16": me.MATMUL_BIAS_ACT_BF16}
    out.update({k.name: k for k in decode_kernels().values()})
    return out


def step_launches(name, step, kernels):
    """``{kernel: [eager, replayed]}`` launches per step of ``step``'s
    path (the kernels it launches at all); fails unless a replayed step
    launches each of ``kernels`` as often as an eager step and the path
    launches at least one."""
    from paddle_tpu_torch.tools.check_step_capture import launches_per_step

    eager = launches_per_step(step, kernels, "0")
    replayed = launches_per_step(step, kernels, "1")
    out = {n: [eager[n], replayed[n]] for n in kernels
           if eager[n] or replayed[n]}
    if not out or any(a != b for a, b in out.values()):
        fail(f"compiled step {name}: kernel launches per step, eager vs "
             f"replayed: {out}")
    return out


def compiled_static_times(torch, name, run, kernels, host_feeds=None):
    """Session turns (off, on, on, off) of a :func:`train` result's step:
    wall and busy ms per step and the idle share, the graphs its
    executor captured (one signature: one) and the kernels' launches per
    step, eager and replayed.  ``host_feeds``: numpy batches for
    ``feed_turns`` (host feeds straight, and staged with the double
    buffer off and on)."""
    from paddle_tpu_torch.tools.step_timing import feed_turns, session_turns

    exe, prog, feed, scope, fetch = (run["executor"], run["program"],
                                     run["feed"], run["scope"], run["fetch"])

    def step():
        exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)

    t = time.perf_counter()
    turns = session_turns(step, TURN_STEPS[name],
                          traced=TRACED_STEPS[name])
    if exe.graphs_captured != 1:
        fail(f"compiled step {name}: {exe.graphs_captured} graphs for one "
             f"signature")
    row = {"path": name, "graphs": exe.graphs_captured, **turns,
           "launches_per_step": step_launches(name, step, kernels)}
    if host_feeds is not None:
        row["host_feeds"] = feed_turns(exe, prog, scope, fetch, host_feeds,
                                       TURN_STEPS[name])
        if exe.graphs_captured != 1:
            fail(f"compiled step {name}: {exe.graphs_captured} graphs "
                 f"after staged feeds")
    row["seconds"] = time.perf_counter() - t
    print("step_capture_time " + json.dumps(row), flush=True)
    return row


def compiled_decode_times(torch, kv_dtype, kernels):
    """The decode step at batch 8 of ``serve()``'s engine (GPT-2 small;
    f32 pools of 1,024 pages, bf16 / int8 from 1,152 MiB), 8 requests of
    32-512 prompt tokens decoding: session turns of ``eng.step``, the
    graphs captured against the buckets used, and the kernels' launches
    per step, eager and replayed."""
    from paddle_tpu_torch.inference.serving import (
        DecoderConfig, Request, ServingEngine, init_decoder_weights)
    from paddle_tpu_torch.tools.step_timing import session_turns

    cfg = DecoderConfig(**GPT2_SMALL)
    pool = dict(num_pages=1024) if kv_dtype == "float32" else \
        dict(kv_budget_mb=KV_BUDGET_MB)
    t = time.perf_counter()
    eng = ServingEngine(cfg, init_decoder_weights(cfg, 0), page_size=16,
                        max_batch=8, token_budget=4096, device="cuda",
                        kv_dtype=kv_dtype, **pool)
    steps = TURN_STEPS["decode"]
    rng = np.random.RandomState(0)
    for i, n in enumerate(rng.randint(32, 513, size=8)):
        eng.submit(Request(i, rng.randint(0, cfg.vocab_size,
                                          size=int(n)).tolist(),
                           max_new_tokens=10 * steps + 26))
    while eng.waiting or eng._prefill_job is not None:
        eng.step()
    turns = session_turns(eng.step, steps, traced=TRACED_STEPS["decode"])
    launches = step_launches(f"decode {kv_dtype}", eng.step, kernels)
    if len(eng.running) != 8:
        fail(f"compiled decode {kv_dtype}: {len(eng.running)} of 8 "
             f"requests still decoding")
    buckets = len(eng.core._buckets)
    if not 0 < eng.graphs_captured <= buckets:
        fail(f"compiled decode {kv_dtype}: {eng.graphs_captured} graphs for "
             f"{buckets} buckets")
    row = {"path": f"decode_{kv_dtype}", "batch": 8,
           "pages": eng.core.kv_config.num_pages,
           "graphs": eng.graphs_captured, "buckets": buckets, **turns,
           "launches_per_step": launches,
           "seconds": time.perf_counter() - t}
    print("step_capture_time " + json.dumps(row), flush=True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return row


def compiled_step_phase(torch):
    """The compiled step (``FLAGS_cuda_step_session`` at auto: on): the
    equality, invalidation, dropout and raise checks of
    ``tools/check_step_capture.py`` (ResNet-18 in f32, bf16 and fp16 with
    an Inf step, LeNet and word2vec, 4 steps each; decode over f32, bf16
    and int8 pools at GPT-2 small's widths cut to 4 layers), then wall
    and busy ms per step and the idle share with the session off and
    on, in turns, of AMP ResNet-50 bf16 at batch 128 (and its host feeds
    straight and staged), LeNet f32 and AMP, word2vec and the decode
    step at batch 8 in each KV dtype; on each timed path a replayed step
    launches every kernel as often as an eager step (a capture records
    launches, a replay counts them), and every kernel of these paths
    launched in the phase."""
    from paddle_tpu_torch.tools import check_step_capture as csc
    from paddle_tpu_torch.tools import train_book as tb
    from paddle_tpu_torch.tools.train_resnet import (make_batch,
                                                     set_card_precision,
                                                     train)
    from paddle_tpu_torch.utils import flags

    set_card_precision()
    flags.set_flags({"FLAGS_cuda_step_session": "auto"})
    kernels = step_kernels()
    reset_counts(kernels)
    rows = []

    def check(fn, *args, **kw):
        t = time.perf_counter()
        row = dict(fn(*args, **kw), seconds=time.perf_counter() - t)
        print("step_capture_check " + json.dumps(row), flush=True)
        rows.append(row)

    for n in csc.STATIC_CASES:
        check(csc.compare_static, n, steps=4)
    for dt in ("float32", "bfloat16", "int8"):
        pool = dict(num_pages=1024) if dt == "float32" else \
            dict(kv_budget_mb=KV_BUDGET_MB)
        check(csc.compare_decode, dt, DECODE_CHECK, n_requests=8,
              max_new=12, max_batch=8, **pool)
        gc.collect()
        torch.cuda.empty_cache()
    check(csc.check_bucket_switch, "int8", DECODE_CHECK)
    for fn in (csc.check_invalidation, csc.check_dropout, csc.check_raises):
        check(fn)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"compiled step: {len(bad)} checks failed: {bad}")
    times = []
    gc.collect()
    torch.cuda.empty_cache()
    run = train(depth=50, batch=128, image=224, classes=1000, steps=1,
                lr=RESNET_LR, device="cuda", warmup=0, log_every=0,
                amp=True, amp_dtype="bfloat16")
    host = [dict(zip(("img", "label"), make_batch(128, 224, 1000, seed=i)))
            for i in range(2)]
    times.append(compiled_static_times(torch, "resnet50_amp_bf16", run,
                                       kernels, host))
    del run, host
    gc.collect()
    torch.cuda.empty_cache()
    for name, model, amp in (("lenet_f32", "lenet", False),
                             ("lenet_amp_bf16", "lenet", True),
                             ("word2vec_f32", "word2vec", False)):
        run = tb.train(model, tb.DEFAULTS[model], steps=1, device="cuda",
                       log_every=0, amp=amp)
        times.append(compiled_static_times(torch, name, run, kernels))
        del run
    for dt in ("float32", "bfloat16", "int8"):
        times.append(compiled_decode_times(torch, dt, kernels))
    torch.cuda.synchronize()
    launched = {n: k.launches for n, k in kernels.items()}
    if not all(launched.values()):
        fail(f"compiled step: a kernel of its paths never launched: "
             f"{launched}")
    print("step_capture_launches " + json.dumps(launched), flush=True)
    flags.set_flags({"FLAGS_cuda_step_session": "0"})
    return times


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False   # the reference is full f32
    torch.backends.cudnn.allow_tf32 = False
    # bf16 and fp16 GEMMs accumulate in f32 throughout, as the JAX
    # package's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    torch.manual_seed(0)

    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind}; "
          f"capability {cap}; {torch.cuda.device_count()} device(s)",
          flush=True)
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels target sm_90a")

    from paddle_tpu_torch import kernel_build
    from paddle_tpu_torch.ops.bn_act import BN_ACT
    from paddle_tpu_torch.utils import flags

    # every phase before the compiled step's runs its steps op by op,
    # the path its launch counts and per-op profiles were first taken on;
    # the compiled step's phase holds a replay's launches to an eager
    # step's
    flags.set_flags({"FLAGS_cuda_step_session": "0"})
    from paddle_tpu_torch.ops.flash_attention import FLASH

    from paddle_tpu_torch.ops.gelu import GELU
    from paddle_tpu_torch.ops.matmul_epilogue import (MATMUL_BIAS_ACT,
                                                      MATMUL_BIAS_ACT_TC)
    from paddle_tpu_torch.ops.paged_attention import PAGED_ATTENTION

    phase("build")
    kernels = [PAGED_ATTENTION, FLASH, BN_ACT, MATMUL_BIAS_ACT,
               MATMUL_BIAS_ACT_TC, GELU]
    kernel_build.build_all(kernels)
    for k in kernels:
        print(f"built {k.source} in {k.build_seconds:.2f} s", flush=True)
        for ln in k.build_log.splitlines():
            if ("registers" in ln or "spill" in ln or "error" in ln
                    or "Compiling entry" in ln):
                print("  ptxas: " + ln.strip())
    tensor_core_check(FLASH)
    simt_spill_check(FLASH)
    matmul_tensor_core_check(MATMUL_BIAS_ACT_TC)
    paged_spill_check(PAGED_ATTENTION)

    phase("paged decode f32: kernel vs plain version, times")
    paged_f32 = paged_kernel_phase("float32")

    phase("flash attention: kernels vs plain versions, times")
    flash_errs, flash_times = flash_phase()

    phase("training: BERT-base f32, then seq 2048")
    flash_launches = train_phase(torch)

    phase("training: card vs CPU, 2 layers at full width")
    f32_losses = card_vs_cpu(torch)

    phase("a/b. flash attention bf16: kernels vs plain versions, times")
    flash16_errs, flash16_times = flash_low_phase("bfloat16")

    phase("c. training: BERT-base AMP O1 (bf16), then seq 2048")
    flash16_launches = amp_train_phase(torch, "O1", warmup=2, steps=10)

    phase("d. bf16 gelu: kernels vs plain versions, times")
    gelu_times = gelu_phase()

    phase("d. training: BERT-base AMP O2 (bf16)")
    gelu_launches = amp_train_phase(torch, "O2", warmup=2, steps=5)

    phase("e. training: AMP O1 / O2 card vs CPU, 2 layers at full width")
    amp_card_vs_cpu(torch, f32_losses)

    phase("serving")
    launches, _, f32_tokens = serve(torch)

    phase("conv epilogue: kernels vs plain versions, times")
    epi_errs = check_epilogue()
    epi_times = time_epilogue()

    phase("training: ResNet-50 static, f32, batch 128, 224x224")
    epi_launches = resnet_phase(torch)

    phase("training: ResNet-50 card vs CPU, batch 4, 32x32")
    resnet_card_vs_cpu(torch)

    phase("matmul epilogue: kernel vs plain version, times")
    mm_err, mm_step = matmul_phase()

    phase("training: LeNet static, f32, batch 256")
    mm_launches = book_phase(torch, "lenet", 2, "relu")

    phase("training: word2vec static, f32, batch 256")
    mm_launches += book_phase(torch, "word2vec", 1, "sigmoid")

    phase("training: LeNet card vs CPU, batch 64, 12 steps")
    lenet_card_vs_cpu(torch)

    phase("f. conv epilogue bf16: kernels vs plain versions, times")
    epi16_errs, epi16_sets, layout = check_epilogue_low("bfloat16")
    epi16_times = time_epilogue_low("bfloat16", epi16_sets, layout)
    del epi16_sets
    torch.cuda.empty_cache()

    phase("g. training: ResNet-50 static AMP (bf16, NHWC), batch 128")
    epi16_launches = resnet_amp_phase(torch, "bfloat16")

    phase("h. training: ResNet-50 AMP card vs CPU, batch 4, 32x32")
    resnet_amp_card_vs_cpu(torch, "bfloat16")

    phase("i. matmul epilogue bf16: kernel vs plain version, times")
    mm16_err, mm16_step, _ = matmul_low_phase("bfloat16")

    phase("j. training: LeNet and word2vec static AMP (bf16), batch 256")
    mm16_launches = book_amp_phase(torch, "lenet", 2, "relu", "bfloat16")
    mm16_launches += book_amp_phase(torch, "word2vec", 1, "sigmoid",
                                    "bfloat16")

    phase("k. training: LeNet AMP card vs CPU, batch 64, 12 steps")
    lenet_amp_card_vs_cpu(torch, "bfloat16")

    phase("l. paged decode bf16 / int8: kernels vs plain versions, times")
    quant_rows = {kname: paged_kernel_phase(dtype)
                  for dtype, kname in QUANT_ROWS}

    phase("m. serving, bf16 and int8 KV pools")
    quant_serving = {}
    for dtype, kname in QUANT_ROWS:
        n, report, tokens = serve(torch, dtype)
        share = token_share(tokens, f32_tokens)
        print(f"serving_{dtype}_tokens_equal_to_f32 {share:.4f}", flush=True)
        quant_serving[kname] = n

    phase("n. prefix cache and chunked prefill on the card, bf16 and int8")
    ties = prefix_chunk_phase(torch)

    phase("o. serving card vs CPU, 2 layers, bf16 and int8 KV pools")
    quant_card_vs_cpu(torch, ties)

    phase("9b. serving completeness: sampled and speculative decoding, "
          "static batching, slo_aware admission, telemetry")
    serving_completeness_phase(torch, f32_tokens, ties)

    phase("p. conv epilogue fp16: kernels vs plain versions, times")
    epi_h_errs, epi_h_sets, layout = check_epilogue_low("float16")
    epi_h_times = time_epilogue_low("float16", epi_h_sets, layout)
    del epi_h_sets
    torch.cuda.empty_cache()

    phase("q. matmul epilogue fp16: kernel vs plain version, times")
    mm_h_err, mm_h_step, _ = matmul_low_phase("float16")

    phase("r. training: ResNet-50 static AMP (fp16, loss scaling), "
          "batch 128")
    epi_h_launches = resnet_amp_phase(torch, "float16")

    phase("s. training: ResNet-50 fp16 AMP card vs CPU, batch 4, 32x32")
    resnet_amp_card_vs_cpu(torch, "float16")
    if not resnet_amp_card_vs_cpu(torch, "float16", FP16_CLEAN_SCALE):
        fail(f"fp16 ResNet-50 at the oracle size found an Inf at step 1 "
             f"from a scale of {FP16_CLEAN_SCALE}")

    phase("t. training: LeNet and word2vec static AMP (fp16), batch 256")
    mm_h_launches = book_amp_phase(torch, "lenet", 2, "relu", "float16")
    mm_h_launches += book_amp_phase(torch, "word2vec", 1, "sigmoid",
                                    "float16")

    phase("u. training: LeNet fp16 AMP card vs CPU, batch 64, 12 steps")
    lenet_amp_card_vs_cpu(torch, "float16")

    # dygraph AMP in fp16
    phase("v. flash attention fp16: kernels vs plain versions, times")
    flash_h_errs, flash_h_times = flash_low_phase("float16")

    phase("w. training: BERT-base AMP O1 (fp16), then seq 2048")
    flash_h_launches = amp_train_phase(torch, "O1", warmup=2, steps=10,
                                       amp_dtype="float16")

    phase("x. fp16 gelu: kernels vs plain versions, times")
    gelu_h_times = gelu_phase("float16")

    phase("x. training: BERT-base AMP O2 (fp16)")
    gelu_h_launches = amp_train_phase(torch, "O2", warmup=2, steps=5,
                                      amp_dtype="float16")

    phase("y. training: AMP O1 / O2 fp16 card vs CPU, 2 layers at full "
          "width")
    amp_card_vs_cpu(torch, f32_losses, "float16")

    phase("z. head dims 40-160: flash and paged decode kernels vs plain")
    head_dim_phase()

    phase("16a. MobileNetV3-large static training: f32, bf16, fp16")
    mobilenet_phase(torch)

    phase("compiled step: captured vs eager, graphs, times in turns")
    compiled_step_phase(torch)

    rows = [{
        "name": "paged_decode_f32", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:845",
        "launches": launches, "max_abs_err": paged_f32["max_abs_err"],
        "ms": paged_f32["ms"], "plain_ms": paged_f32["plain_ms"],
        "bound_ms": paged_f32["bound_ms"], "bound_by": paged_f32["bound_by"],
        "library_ms": paged_f32["library_ms"]}]
    for _, name in QUANT_ROWS:
        t = quant_rows[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels.py:845",
            "launches": quant_serving[name], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    for name, replaces in FLASH_ROWS:
        # each kernel at the shape the training path launches it at
        t = flash_times[MAIN_PATH_SHAPE[name]][name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "launches": flash_launches[name],
            "max_abs_err": flash_errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    for flash_rows, times, launched, errs in (
            (FLASH_BF16_ROWS, flash16_times, flash16_launches, flash16_errs),
            (FLASH_FP16_ROWS, flash_h_times, flash_h_launches,
             flash_h_errs)):
        for name, replaces in flash_rows:
            # each at the shape the AMP O1 training path launches it at
            t = times[MAIN_PATH_SHAPE[name]][name]
            rows.append({
                "name": name, "route": "cuda",
                "source": "paddle_tpu_torch/csrc/flash_attention.cu",
                "replaces": replaces, "launches": launched[name],
                "max_abs_err": errs[name], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    for name, replaces in EPILOGUE_ROWS:
        t = epi_times[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/bn_act.cu",
            "replaces": replaces, "launches": epi_launches[name],
            "max_abs_err": epi_errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    # kernel 9 per LeNet training step (its four calls)
    rows.append({
        "name": "matmul_bias_act_f32", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/matmul_bias_act.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:1186",
        "launches": mm_launches, "max_abs_err": mm_err, "ms": mm_step["ms"],
        "plain_ms": mm_step["plain_ms"], "bound_ms": mm_step["bound_ms"],
        "bound_by": mm_step["bound_by"],
        "library_ms": mm_step["library_ms"]})
    for name, replaces in EPILOGUE_BF16_ROWS:
        t = epi16_times[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/bn_act.cu",
            "replaces": replaces, "launches": epi16_launches[name],
            "max_abs_err": epi16_errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    # the bf16 kernel 9 per AMP LeNet training step (its four calls)
    rows.append({
        "name": "matmul_bias_act_bf16", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/matmul_bias_act_tc.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:1186",
        "launches": mm16_launches, "max_abs_err": mm16_err,
        "ms": mm16_step["ms"], "plain_ms": mm16_step["plain_ms"],
        "bound_ms": mm16_step["bound_ms"],
        "bound_by": mm16_step["bound_by"],
        "library_ms": mm16_step["library_ms"]})
    for name, replaces in EPILOGUE_FP16_ROWS:
        t = epi_h_times[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/bn_act.cu",
            "replaces": replaces, "launches": epi_h_launches[name],
            "max_abs_err": epi_h_errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    # the fp16 kernel 9 per fp16 AMP LeNet training step (its four calls)
    rows.append({
        "name": "matmul_bias_act_fp16", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/matmul_bias_act_tc.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:1186",
        "launches": mm_h_launches, "max_abs_err": mm_h_err,
        "ms": mm_h_step["ms"], "plain_ms": mm_h_step["plain_ms"],
        "bound_ms": mm_h_step["bound_ms"],
        "bound_by": mm_h_step["bound_by"],
        "library_ms": mm_h_step["library_ms"]})
    # the bf16 and fp16 gelu of the AMP O2 paths (no Pallas kernel: XLA
    # fuses the JAX lowering); bit-equal to their plain versions
    for gelu_rows, times, launched in ((GELU_ROWS, gelu_times, gelu_launches),
                                       (GELU_FP16_ROWS, gelu_h_times,
                                        gelu_h_launches)):
        for name, replaces in gelu_rows:
            t = times[name]
            rows.append({
                "name": name, "route": "cuda",
                "source": "paddle_tpu_torch/csrc/gelu_lowp.cu",
                "replaces": replaces, "launches": launched[name],
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    phase("done")
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
