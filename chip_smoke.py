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
3. paged decode, kernel vs plain version: the paged-decode kernel against
   its plain PyTorch version on the card, at the serving shape and a GQA
   shape;
4. paged decode, times (calls captured in a CUDA graph, replayed between
   CUDA events after warm-up; inputs rotated through enough copies to
   keep the 50 MB L2 cold, as in a 12-layer decode step): kernel, plain
   version, the bound of the bytes the live K/V rows need, and
   ``scaled_dot_product_attention`` over gathered dense K/V as a library
   yardstick (the port never calls it);
5. flash attention, kernels vs plain versions: the forward (out and lse)
   and the fused and split backward kernels against the plain forward
   and autograd of the dense plain version on the same CUDA tensors, at
   the BERT-base shape (b 44, h 12, s 512, d 64, a padding bias) and a
   long shape (b 2, h 12, s 2048, d 64, causal and not), with dropout 0
   and 0.1 (the plain side takes ``flash_dropout_mask``'s mask); the
   keep rate within 4 sigma of the binomial, and one seed giving the same
   output bit for bit;
6. flash attention, times at the two training configurations (padding
   bias, dropout 0.1, not causal; the BERT shape and s=2048): the
   kernels and plain versions by CUDA-graph replay, cold L2; the library
   call between CUDA events, SDPA's forward, and its backward alone (the
   forward run outside the timed region); against the bound
   max(bytes / 3.35 TB/s, flops / 67 TFLOP/s);
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
   b. their times, as phase 6 (CUDA-graph replay, cold L2), against the
      plain versions, SDPA in bf16 (forward, and backward alone), and the
      bound max(bytes at 2 bytes an element / 3.35 TB/s, flops / 989
      TFLOP/s, the dense bf16 tensor-core peak);
   c. BERT-base under AMP O1 through ``jit_train_step(amp=True)``: batch
      44 x seq 512 with padding, dropout 0.1, ``AdamOptimizer(1e-4)``, 2
      warm-up and 10 timed steps on one batch; the loss finite and
      falling, each step launching ``flash_fwd_bf16`` and
      ``flash_bwd_fused_bf16`` 12 times and no f32 flash kernel; tokens/s,
      ms/step and ``max_memory_allocated``; then 3 steps at seq 2048
      (batch 2), whose backward launches the split bf16 pair 12 times each;
   d. the bf16 gelu kernels (``gelu_fwd_bf16``, ``gelu_bwd_bf16``, the
      rounding points of JAX's compiled gelu) against their plain versions
      bit for bit at BERT's FFN shape and a ragged one, and timed against
      the byte bound, the plain versions and ``F.gelu`` in bf16; then the
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
    it), TF32 off; the four calls of one LeNet step timed together;
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
      both timed over the 49 NHWC calls (the main path's layout) against
      the byte bound (bf16 data) and their plain versions;
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
      phase 13's shapes and every act against its plain version (the AMP
      program's unfused chain): every output within one bf16 ulp of the
      largest, a bf16 bias once; timed against the bound (2MNK / 989
      TFLOP/s, bf16 operand bytes), the plain version and ``torch.addmm``
      in bf16 plus the act; the four calls of one LeNet step together;
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
      ``code * (scale / 127)``), and timed as phase 4 (CUDA-graph replay,
      enough input sets to keep the L2 cold) against the byte bound, the
      plain versions and SDPA (bf16 over gathered bf16 K/V; for int8,
      which no PyTorch call takes, over K/V dequantized to f32
      beforehand);
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

17. the ``kernels`` line, one row per TPU kernel of
    ``paddle_tpu/ops/pallas_kernels.py`` and dtype: the nine f32 rows
    (``flash_fwd_f32`` replaces two), the two quantized rows of kernel 6
    (launches from phase m), the five bf16 rows of kernels 1-5
    (the bf16 launches from phase c, the AMP O1 main path), the three
    bf16 rows of kernels 7-9 (launches from phases g and j), and the two
    bf16 gelu kernels of the AMP O2 path (launches from phase d; no
    Pallas kernel: their row names the JAX lowering XLA fuses), the
    card's name and power limit, and the last line:
    ``{"ok": true, "device": {...}}``.

Each phase's heading carries the seconds since the start.  The port is
imported only after the device check, so run without the rest of the
repository, or without a CUDA device, it fails.
"""
import gc
import json
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
# the card could take for the bf16 kernels' products
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

    for args in args_sets:   # warm-up: library loaded, allocator primed
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


def decode_bound(case):
    """(bound_ms, bound_by): the bytes the live K/V rows, q, out, tables
    and lengths need, over HBM bandwidth, against the f32 operations
    over the f32 peak."""
    q, k, _, tables, ctx = case
    b, hq, d = q.shape
    hkv = k.shape[0]
    tokens = int(ctx.sum())
    nbytes = (2 * tokens * hkv * d * 4 + 2 * q.numel() * 4
              + tables.numel() * 4 + ctx.numel() * 4)
    flops = 4 * d * hq * tokens
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def check_and_time_kernel(name, rng, hq, hkv, d, ps, n_pages, ctx_lens,
                          n_pad=0, n_sets=4):
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import paged_attention as pa

    cases = [make_decode_case(rng, hq, hkv, d, ps, n_pages, ctx_lens, n_pad)
             for _ in range(n_sets)]
    scale = d ** -0.5
    err = 0.0
    for c in cases:
        got = pa.paged_decode(*c, scale)
        want = pa.paged_attention_reference(*c, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"{name}: kernel output not finite")
        err = max(err, float((got - want).abs().max()))
    if err > KERNEL_ATOL:
        fail(f"{name}: kernel vs plain max |err| {err:.3e} > {KERNEL_ATOL}")
    ms = time_ms(lambda *c: pa.paged_decode(*c, scale), cases)
    plain_ms = time_ms(lambda *c: pa.paged_attention_reference(*c, scale),
                       cases)
    lib_sets = [sdpa_inputs(c) for c in cases]
    lib_ms = time_ms(lambda q, kd, vd, m: F.scaled_dot_product_attention(
        q, kd, vd, attn_mask=m, scale=scale), lib_sets)
    bound_ms, bound_by = decode_bound(cases[0])
    row = {"shape": name, "B": len(cases[0][4]), "Hq": hq, "Hkv": hkv,
           "D": d, "page_size": ps, "width": int(cases[0][3].shape[1]),
           "ctx": [int(x) for x in cases[0][4].tolist()],
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}
    print("kernel_case " + json.dumps(row), flush=True)
    return row


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
EPILOGUE_ROWS = (  # (kernel name, TPU kernel it replaces)
    ("bn_act_apply_f32", "paddle_tpu/ops/pallas_kernels.py:1039"),
    ("bn_act_bwd_f32", "paddle_tpu/ops/pallas_kernels.py:1131"),
)
# the timing case the training path launches each kernel at: the backward
# takes the fused kernel at seq 512 and the split pair at seq 2048
MAIN_PATH_SHAPE = {f"flash_{k}_{t}": shape
                   for k, shape in (("fwd", "bert"), ("bwd_fused", "bert"),
                                    ("bwd_dq", "long"), ("bwd_dkv", "long"))
                   for t in ("f32", "bf16")}


def flash_kernels(dtype="f32"):
    """{name: KernelFunction} of the four flash kernels of one dtype
    ("f32", "bf16" or "all")."""
    from paddle_tpu_torch.ops import flash_attention as fa

    kfs = {"f32": (fa.FLASH_FWD, fa.FLASH_BWD_FUSED, fa.FLASH_BWD_DQ,
                   fa.FLASH_BWD_DKV),
           "bf16": (fa.FLASH_FWD_BF16, fa.FLASH_BWD_FUSED_BF16,
                    fa.FLASH_BWD_DQ_BF16, fa.FLASH_BWD_DKV_BF16)}
    pick = kfs["f32"] + kfs["bf16"] if dtype == "all" else kfs[dtype]
    return {kf.name: kf for kf in pick}


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


def flash_bound(name, case, causal):
    """(bound_ms, bound_by): each input read once and each output written
    once over HBM bandwidth, against the flops the function needs (per
    attended pair and head dim: forward 4, dQ 6 [S, dP, dS K], dK/dV 8
    [S, dP, dS^T Q, P^T dO], fused 10) over the card's peak for their
    type: f32 outside the tensor cores for the f32 kernels, the bf16
    tensor cores for the bf16 ones.  q, k, v, dO and the outputs count 4
    or 2 bytes an element; lse, delta and the bias 4."""
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
    per_pair = {"flash_fwd": 4, "flash_bwd_fused": 10, "flash_bwd_dq": 6,
                "flash_bwd_dkv": 8}[kind]
    bf16 = name.endswith("_bf16")
    flops = per_pair * d * attended_pairs(b, h, sq, sk, causal)
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
    library call (SDPA) runs in bf16 too."""
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
        print(f"flash_time {kname} " + json.dumps(rows[kname]), flush=True)
    return rows


def flash_phase():
    """Checks at both shapes, dropout 0 and 0.1, then times at the two
    training configurations (padding bias, dropout 0.1, not causal): the
    BERT shape, whose backward takes the fused kernel, and s=2048, whose
    backward takes the split pair.  Returns ({kernel: max abs err},
    {shape: {kernel: timing row}})."""
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
def ulps_off(got, want) -> float:
    """max |got - want| in bf16 ulps of the largest |want| (2^-8 of it)."""
    scale = 2.0 ** -8 * float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / scale


def bf16_case(case):
    q, k, v, do, bias = case
    return (*(t.bfloat16() for t in (q, k, v, do)), bias)


def check_flash_bf16(name, case, causal, rate):
    """The four bf16 kernels against the bf16 plain versions (which round
    where the kernels round), the keep rate, determinism, and the bf16
    kernels against the f32 ones on the same bf16-representable inputs;
    returns {kernel: max abs error}."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    q, k, v, do, bias = case
    b, h, s, d = q.shape
    scale = d ** -0.5
    seed = torch.tensor([20261], dtype=torch.int64, device="cuda")
    keep = fa.flash_dropout_mask(b, h, s, s, rate, seed) if rate else None
    out, lse = fa.flash_fwd(q, k, v, bias, scale, causal, rate, seed)
    want_out, want_lse = fa.flash_fwd_reference(q, k, v, bias, scale,
                                                causal, rate, keep)
    ulps = {"flash_fwd_bf16": ulps_off(out, want_out)}
    errs = {"flash_fwd_bf16": float((out.float() - want_out.float())
                                    .abs().max())}
    lse_err = float((lse - want_lse).abs().max())
    if (out.dtype != torch.bfloat16 or not torch.isfinite(out).all()
            or ulps["flash_fwd_bf16"] > BF16_ULPS or lse_err > KERNEL_ATOL):
        fail(f"flash bf16 {name} rate {rate}: forward {out.dtype} vs plain "
             f"{ulps['flash_fwd_bf16']:.2f} ulps (limit {BF16_ULPS}), lse "
             f"{lse_err:.3e} (limit {KERNEL_ATOL})")
    want = fa.flash_bwd_reference(q, k, v, bias, out, lse, do, scale, causal,
                                  rate, keep)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, bias, do, lse, delta, scale, causal, rate, seed)
    got = {"flash_bwd_fused_bf16": (fa.bwd_fused(*args), want),
           "flash_bwd_dq_bf16": ((fa.bwd_dq(*args),), want[:1]),
           "flash_bwd_dkv_bf16": (fa.bwd_dkv(*args), want[1:])}
    torch.cuda.synchronize()
    for kname, (grads, wants) in got.items():
        us = [ulps_off(g, w) for g, w in zip(grads, wants)]
        if max(us) > BF16_ULPS or any(g.dtype != torch.bfloat16
                                      for g in grads):
            fail(f"flash bf16 {name} rate {rate}: {kname} gradients "
                 f"{max(us):.2f} ulps from the plain version's (limit "
                 f"{BF16_ULPS})")
        ulps[kname] = max(us)
        errs[kname] = max(float((g.float() - w.float()).abs().max())
                          for g, w in zip(grads, wants))
    # the bf16 kernels against the f32 ones on the same inputs: apart by
    # about a bf16 rounding, far above the f32 kernels' noise
    f32 = [t.float() for t in (q, k, v, do)]
    o32, l32 = fa.flash_fwd(*f32[:3], bias, scale, causal, rate, seed)
    g32 = fa.flash_bwd(*f32[:3], bias, o32, l32, f32[3], scale, causal,
                       rate, seed)
    g16 = fa.flash_bwd(q, k, v, bias, out, lse, do, scale, causal, rate,
                       seed)
    vs_f32 = [ulps_off(a, w) for a, w in zip((out, *g16), (o32, *g32))]
    if not all(2.0 ** -4 < u <= BF16_ULPS for u in vs_f32):
        fail(f"flash bf16 {name} rate {rate}: bf16 vs f32 kernels "
             f"{vs_f32} ulps, expected a bf16 rounding (0.0625, "
             f"{BF16_ULPS}]")
    if rate:
        again, _ = fa.flash_fwd(q, k, v, bias, scale, causal, rate, seed)
        if not torch.equal(again, out):
            fail(f"flash bf16 {name}: the same seed gave another output")
        n = keep.numel()
        kept = float(keep.sum(dtype=torch.float64))
        sigma = (n * rate * (1 - rate)) ** 0.5
        if abs(kept - n * (1 - rate)) > 4 * sigma:
            fail(f"flash bf16 {name}: keep rate {kept / n:.6f} is more "
                 f"than 4 sigma from {1 - rate}")
    print("flash_check_bf16 " + json.dumps({
        "case": name, "causal": causal, "dropout": rate, "lse_err": lse_err,
        "ulps": ulps, "bf16_vs_f32_ulps": vs_f32, **errs}), flush=True)
    return errs


def flash_bf16_phase():
    """Phase a (checks at the BERT-base and long shapes, causal and not,
    dropout 0 and 0.1) and phase b (times at the two training
    configurations).  Returns ({kernel: max abs err}, {shape: rows})."""
    import torch

    errs = {name: 0.0 for name, _ in FLASH_BF16_ROWS}
    bert = bf16_case(make_flash_case(11, 44, 12, 512, 64, True))
    long_bias = bf16_case(make_flash_case(12, 2, 12, 2048, 64, True))
    long_causal = bf16_case(make_flash_case(13, 2, 12, 2048, 64, False))
    for name, case, causal in (("bert", bert, False),
                               ("bert_causal", bert, True),
                               ("long", long_bias, False),
                               ("long_causal", long_causal, True)):
        for rate in (0.0, 0.1):
            for kname, e in check_flash_bf16(name, case, causal,
                                             rate).items():
                errs[kname] = max(errs[kname], e)
    torch.cuda.empty_cache()
    times = {"bert": time_flash("bert", [bert, bf16_case(make_flash_case(
                 14, 44, 12, 512, 64, True))], False, 0.1, "bf16"),
             "long": time_flash("long", [long_bias] + [
                 bf16_case(make_flash_case(15 + i, 2, 12, 2048, 64, True))
                 for i in range(2)], False, 0.1, "bf16")}
    torch.cuda.empty_cache()
    return errs, times


def gelu_kernels():
    from paddle_tpu_torch.ops import gelu

    return {"gelu_fwd_bf16": gelu.GELU_FWD_BF16,
            "gelu_bwd_bf16": gelu.GELU_BWD_BF16}


def train_amp(torch, level, cfg, batch, seq, warmup, steps):
    """One AMP run through ``tools/train_bert.train``; returns the run,
    the launches of every flash kernel during it, and the bf16 gelu
    kernels' (in ``run["gelu_launches"]``)."""
    from paddle_tpu_torch.tools.train_bert import train

    kernels = flash_kernels("all")
    gk = gelu_kernels()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    reset_counts(gk)
    run = train(cfg, batch=batch, seq=seq, steps=steps, lr=1e-4,
                device="cuda", pad=True, warmup=warmup, log_every=1,
                amp=True, amp_level=level)
    torch.cuda.synchronize()
    run["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    run["gelu_launches"] = {n: kf.launches for n, kf in gk.items()}
    return run, {n: kf.launches for n, kf in kernels.items()}


def check_amp_run(what, run, launches, n_steps, layers, split):
    """Losses finite and falling, and per step one launch per layer of
    the bf16 forward and of the bf16 backward (fused, or the split pair),
    and no f32 flash kernel."""
    losses = run["losses"]
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{what}: losses {losses} not finite or not falling")
    n = layers * n_steps
    want = {name: 0 for name in launches}
    want["flash_fwd_bf16"] = n
    for kname in (("flash_bwd_dq_bf16", "flash_bwd_dkv_bf16") if split
                  else ("flash_bwd_fused_bf16",)):
        want[kname] = n
    if launches != want:
        fail(f"{what}: flash launches {launches}, expected {want} (layers "
             f"{layers} x steps {n_steps}, bf16 only)")


def amp_train_phase(torch, level, warmup, steps):
    """Phase c (O1) or d (O2): BERT-base at batch 44 x seq 512 under AMP;
    for O1 also 3 steps at seq 2048 (the split backward).  Returns the
    bf16 flash kernels' launches, and for O2, whose gelus are bf16
    (under O1 the bias add promotes them to f32), the gelu kernels' too:
    one forward and one backward per step for each layer's FFN and for
    the MLM head's transform."""
    from paddle_tpu_torch.models.bert import BertConfig

    layers = BertConfig().num_hidden_layers
    run, launches = train_amp(torch, level, BertConfig(), 44, 512, warmup,
                              steps)
    check_amp_run(f"AMP {level} BERT-base", run, launches, warmup + steps,
                  layers, split=False)
    gl = run["gelu_launches"]
    n_gelu = (layers + 1) * (warmup + steps) if level == "O2" else 0
    if gl != {"gelu_fwd_bf16": n_gelu, "gelu_bwd_bf16": n_gelu}:
        fail(f"AMP {level} BERT-base: gelu launches {gl}, expected "
             f"{n_gelu} each")
    if level == "O2":
        # every parameter bf16; every one the optimizer has updated (all
        # but the pooler and the NSP head, which the MLM loss gives no
        # gradient) has an f32 master and f32 moments
        params = run["model"].parameters()
        states = [run["optimizer"]._state.get(id(p)) for p in params]
        updated = [st for st in states if st is not None]
        if (any(p.dtype != torch.bfloat16 for p in params)
                or len(updated) != len(params) - 4
                or any(st[key].dtype != torch.float32 for st in updated
                       for key in ("master", "m1", "m2"))):
            fail("AMP O2: a parameter is not bf16, or an updated one lacks "
                 "an f32 master and f32 moments")
    print("training_amp " + json.dumps({
        "model": f"BERT-base AMP {level} bf16", "batch": 44, "seq": 512,
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
            1, 2)
        check_amp_run("AMP O1 seq 2048", long_run, longl, 3, layers,
                      split=True)
        print("training_amp_long " + json.dumps({
            "batch": 2, "seq": 2048, "losses": long_run["losses"],
            "ms_per_step": long_run["ms_per_step"], "launches": longl}),
            flush=True)
        total = {n: total[n] + longl[n] for n in total}
        del long_run
    torch.cuda.empty_cache()
    return {n: c for n, c in total.items() if n.endswith("_bf16")}


def amp_card_vs_cpu(torch, f32_losses):
    """Phase e: 2 layers at full width, the same weights and batch as the
    f32 card-vs-CPU phase, 3 Adam steps under AMP O1 and O2 on the card
    (bf16 kernels) and on the CPU (plain versions)."""
    from paddle_tpu_torch.dygraph import jit_train_step, to_tensor
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import AdamOptimizer
    from paddle_tpu_torch.tools.train_bert import make_batch

    cfg = BertConfig(num_hidden_layers=2, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    batch = make_batch(cfg, 2, 128, seed=3, pad=True)
    weights = BertForPretraining(cfg, device="cpu", seed=0).state_dict()
    fwd16 = flash_kernels("bf16")["flash_fwd_bf16"]
    result = {}
    for level in ("O1", "O2"):
        losses = {}
        for dev in ("cpu", "cuda"):
            model = BertForPretraining(cfg, device=dev, seed=1)
            model.set_dict(weights)
            step = jit_train_step(model, AdamOptimizer(
                1e-4, parameter_list=model.parameters()),
                lambda m, i, l, a: m(i, l, attention_mask=a), amp=True,
                amp_level=level)
            inputs = [to_tensor(x, dev) for x in batch]
            launched = fwd16.launches
            losses[dev] = [float(step(*inputs)) for _ in range(3)]
            if dev == "cuda" and fwd16.launches != launched + 2 * 3:
                fail(f"AMP {level} card vs CPU: the card's run did not "
                     f"launch the bf16 flash kernels")
        rel = max(abs(a - b) / abs(a) for a, b in zip(losses["cpu"],
                                                      losses["cuda"]))
        vs_f32 = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                         f32_losses))
        result[level] = {**losses, "max_rel_diff": rel, "rtol":
                         AMP_LOSS_RTOL, "vs_f32_max_rel": vs_f32}
        if not rel <= AMP_LOSS_RTOL:
            fail(f"AMP {level} card vs CPU losses differ by {rel:.3e} > "
                 f"{AMP_LOSS_RTOL}")
        if level == "O1" and not vs_f32 > LOSS_RTOL:
            fail(f"AMP O1 losses within {vs_f32:.3e} of the f32 run's "
                 f"(f32 tolerance {LOSS_RTOL}): bf16 did not run")
    print("amp_card_vs_cpu " + json.dumps(result), flush=True)


# ==========================================================================
# the conv epilogue kernels, and ResNet-50 static training
# ==========================================================================
def resnet50_epilogue_shapes(amp=False, nhwc=False):
    """[(conv-output shape, has z)] of the 49 fused_conv_bn_act ops of the
    ResNet-50 training program at batch 128, 224x224, in program order;
    ``nhwc``: as the NHWC layout pass leaves them (channels last)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.tools.train_resnet import build_program
    from paddle_tpu_torch.utils import flags

    names = ("FLAGS_cuda_fuse", "FLAGS_cuda_nhwc")
    prev = {k: flags.get_flag(k) for k in names}
    flags.set_flags({"FLAGS_cuda_fuse": "1",
                     "FLAGS_cuda_nhwc": "1" if nhwc else "0"})
    try:
        main, _, loss, acc1 = build_program(50, 224, 1000, amp=amp)
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


def path_layout(amp):
    """(nhwc, channel axis) of the ResNet-50 program's convolutions on
    the card: ``FLAGS_cuda_nhwc`` resolved for a CUDA place, as the
    executor resolves it (``auto``: NHWC for bf16 convolutions only)."""
    import torch

    from paddle_tpu_torch.utils.flags import cuda_nhwc_enabled

    nhwc = cuda_nhwc_enabled(torch.device("cuda"), bf16_convs=amp)
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

    path_nhwc, _ = path_layout(amp=False)
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
    layout = "NHWC" if path_layout(amp=False)[0] else "NCHW"
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
        row = {"shape": name, "M": m, "K": k, "N": n}
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
EPILOGUE_BF16_ROWS = tuple((name.replace("_f32", "_bf16"), replaces)
                           for name, replaces in EPILOGUE_ROWS)
# the steepest slope of kernel 9's acts (exact gelu's peaks at 1.13)
MATMUL_BF16_SLOPE = 1.13
# the AMP ResNet-50 step-1 loss on the card (NHWC, cuDNN bf16, the bf16
# kernels) vs on the CPU (NCHW, oneDNN bf16, the plain versions) from one
# startup scope: bf16 roundings in two summation orders through 50
# layers of BN over four values per channel (1x1 maps) at batch 4, where
# the loss is chaotic: half a bf16 ulp of noise (2^-9 relative) on the
# images moves the CPU's own step-1 loss by 16% (printed each run as
# cpu_noise_step1_rel).  Card vs CPU measured 9.3e-3 in two runs (both
# sides deterministic): held to twice that.  After step 1 every state
# tensor (``rel_errs``: its largest difference over the CPU's largest
# magnitude) is held, velocities (the step-1 gradients) and the rest
# apart, to twice the noisy CPU twin's worst and median
AMP_RESNET_NOISE = 2.0 ** -9
AMP_RESNET_STEP1_RTOL = 2e-2
# AMP LeNet on the card vs on the CPU from one startup scope, 12 steps:
# step 1 relative, every step absolute (bf16 products in two orders; on
# the CPU JAX and the port differ by 2.1e-4 at step 1, 6.4e-3 by step 4)
AMP_LENET_STEP1_RTOL, AMP_LENET_LOSS_ATOL = 2e-3, 5e-2


def gelu_phase():
    """The bf16 gelu kernels against their plain versions bit for bit at
    BERT-base's FFN shape (22528 x 3072) and a ragged one, then timed at
    the FFN shape against the bound, the plain versions and ``F.gelu`` in
    bf16 (forward; its backward alone).  Returns {kernel: row}."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import gelu

    rows = {}
    errs = {"gelu_fwd_bf16": 0.0, "gelu_bwd_bf16": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(21)
    ffn = (22528, 3072)
    for shape in (ffn, (1001, 37)):
        x = (torch.randn(shape, device="cuda", generator=gen) * 3).bfloat16()
        dy = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        got, want = gelu.gelu_fwd_bf16(x), gelu.gelu_bf16_reference(x)
        gdx = gelu.gelu_bwd_bf16(x, dy)
        wdx = gelu.gelu_bf16_grad_reference(x, dy)
        torch.cuda.synchronize()
        fwd = float((got.float() - want.float()).abs().max())
        bwd = float((gdx.float() - wdx.float()).abs().max())
        errs["gelu_fwd_bf16"] = max(errs["gelu_fwd_bf16"], fwd)
        errs["gelu_bwd_bf16"] = max(errs["gelu_bwd_bf16"], bwd)
        if not (torch.equal(got, want) and torch.equal(gdx, wdx)):
            fail(f"gelu bf16 kernels differ from their plain versions at "
                 f"{shape}: forward {fwd}, backward {bwd}")
    n = ffn[0] * ffn[1]
    count = max(2, -(-COLD_BYTES // (4 * n)))
    sets = [((torch.randn(ffn, device="cuda", generator=gen) * 3).bfloat16(),
             torch.randn(ffn, device="cuda", generator=gen).bfloat16())
            for _ in range(count)]

    def lib_bwd(x, dy):
        return torch.ops.aten.gelu_backward(dy, x)

    for name, kern, plain, lib, nbytes in (
            ("gelu_fwd_bf16", lambda x, dy: gelu.gelu_fwd_bf16(x),
             lambda x, dy: gelu.gelu_bf16_reference(x),
             lambda x, dy: F.gelu(x), 4 * n),
            ("gelu_bwd_bf16", gelu.gelu_bwd_bf16,
             gelu.gelu_bf16_grad_reference, lib_bwd, 6 * n)):
        rows[name] = {"shape": list(ffn), "max_abs_err": errs[name],
                      "ms": time_ms(kern, sets, 8, 5),
                      "plain_ms": time_ms(plain, sets, 4, 2),
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bound_by": "bytes",
                      "library_ms": time_ms(lib, sets, 8, 5)}
        print(f"gelu_time {name} " + json.dumps(rows[name]), flush=True)
    del sets
    torch.cuda.empty_cache()
    return rows


def epilogue_bf16_inputs(shape, with_z, seed, c_axis):
    """bf16 x (and z), the bf16 per-channel vectors and an f32 c0."""
    x, z, (a, b, mean, cx) = epilogue_inputs(shape, with_z, seed, c_axis)
    bf = [t.bfloat16() if t is not None else None for t in (x, z, a, b,
                                                           mean, cx)]
    return bf, b.clone()


def epilogue_bf16_bytes(shape, with_z, bwd, c):
    """Bytes each bf16 call must move: data at 2 bytes an element; the
    per-channel vectors at 2 (a, b; cg, mean, cx) and 4 (c0)."""
    n = int(np.prod(shape))
    if bwd:
        return 2 * n * (4 + with_z) + (2 * 3 + 4) * c
    return 2 * n * (2 + with_z) + 2 * 2 * c


def check_epilogue_bf16():
    """Kernels 7 and 8 in bf16 against their plain versions: bit for bit
    for "" and relu and the backward (with and without z / g), within a
    bf16 ulp of the largest output for sigmoid, tanh and gelu, at a
    ragged shape in both layouts and a channels-last (M, C) case; then at
    each of the 49 shapes of the AMP ResNet-50 step, NCHW and NHWC, with
    relu, z where the chain has one and g on the residual chains.
    Returns ({kernel: max err}, the NHWC input sets for the timing)."""
    import torch

    from paddle_tpu_torch.ops import bn_act as ba

    errs = {"bn_act_apply_bf16": 0.0, "bn_act_bwd_bf16": 0.0}

    def one(name, shape, c_axis, with_z, acts, seed):
        (x, z, a, b, mean, cx), c0 = epilogue_bf16_inputs(shape, with_z,
                                                          seed, c_axis)
        for act in acts:
            for zz in ((None, z) if with_z else (None,)):
                got = ba.bn_act_apply(x, a, b, zz, act, c_axis)
                want = ba.bn_act_apply_reference(x, a, b, zz, act, c_axis)
                torch.cuda.synchronize()
                if got.dtype != torch.bfloat16:
                    fail(f"bn_act_apply_bf16 {name}: output {got.dtype}")
                err = ulps_off(got, want)
                if ((act in ("", "relu") and not torch.equal(got, want))
                        or err > 1.0):
                    fail(f"bn_act_apply_bf16 {name} act {act!r} z "
                         f"{zz is not None}: {err:.2f} bf16 ulps off")
                errs["bn_act_apply_bf16"] = max(errs["bn_act_apply_bf16"],
                                                float((got.float()
                                                       - want.float())
                                                      .abs().max()))
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
                if (dx.dtype != torch.bfloat16 or not torch.equal(dx, rdx)
                        or (want_g and not torch.equal(g, rg))):
                    fail(f"bn_act_bwd_bf16 {name} act {act!r} want_g "
                         f"{want_g}: not equal to the plain version "
                         f"(max |err| {err:.3e})")
                errs["bn_act_bwd_bf16"] = max(errs["bn_act_bwd_bf16"], err)
        return x, z, a, b, mean, cx, c0

    for name, shape, c_axis, with_z in (
            ("ragged-nchw", (3, 37, 13, 11), 1, True),
            ("ragged-nhwc", (3, 13, 11, 37), 3, True),
            ("channels-last-mc", (4096, 64), 1, True)):
        one(name, shape, c_axis, with_z, tuple(ba.ACTS), 31)
        print("epilogue_check_bf16 " + json.dumps(
            {"case": name, "shape": list(shape), "c_axis": c_axis,
             "acts": list(ba.ACTS), "bit_exact": ["", "relu", "bwd"]}),
            flush=True)
    nhwc_sets = None
    for layout, c_axis in (("NCHW", 1), ("NHWC", 3)):
        shapes = resnet50_epilogue_shapes(amp=True, nhwc=layout == "NHWC")
        if len(shapes) != 49:
            fail(f"the AMP ResNet-50 program ({layout}) has {len(shapes)} "
                 f"fused conv chains, expected 49")
        sets = []
        for i, (shape, with_z) in enumerate(shapes):
            t = one(f"path {layout} {shape}", shape, c_axis, with_z,
                    ("relu",), 200 + i)
            sets.append((shape, with_z, t))
        print("epilogue_check_bf16 " + json.dumps(
            {"case": f"ResNet-50 AMP path, {layout}", "shapes": 49,
             "bit_exact": True}), flush=True)
        if layout == "NHWC":
            nhwc_sets = sets
        else:
            del sets
    torch.cuda.empty_cache()
    return errs, nhwc_sets


def time_epilogue_bf16(sets):
    """Both bf16 kernels timed over the 49 NHWC calls of one AMP ResNet-50
    step (the main path's layout), every call on its own tensors, by
    CUDA-graph replay, against their plain versions and the byte bound.
    Returns {kernel: row}."""
    import torch

    from paddle_tpu_torch.ops import bn_act as ba

    fwd = [(x, a, b, z) for _, _, (x, z, a, b, mean, cx, c0) in sets]
    bwd = [(torch.relu(x), torch.randn_like(x), x, a, mean, cx, c0,
            z is not None) for _, _, (x, z, a, b, mean, cx, c0) in sets]
    rows = {}
    for name, args, kern, plain, is_bwd in (
            ("bn_act_apply_bf16", fwd,
             lambda x, a, b, z: ba.bn_act_apply(x, a, b, z, "relu", 3),
             lambda x, a, b, z: ba.bn_act_apply_reference(x, a, b, z,
                                                          "relu", 3), False),
            ("bn_act_bwd_bf16", bwd,
             lambda y, dy, x, cg, m, cx, c0, wg: ba.bn_act_bwd_apply(
                 y, dy, x, cg, m, cx, c0, "relu", 3, wg),
             lambda y, dy, x, cg, m, cx, c0, wg: ba.bn_act_bwd_reference(
                 y, dy, x, cg, m, cx, c0, "relu", 3, wg), True)):
        nbytes = sum(epilogue_bf16_bytes(shape, z, is_bwd, shape[3])
                     for shape, z, _ in sets)
        rows[name] = {"calls": len(sets), "layout": "NHWC",
                      "ms": time_ms(kern, args, per_graph=49, replays=5) * 49,
                      "plain_ms": time_ms(plain, args, per_graph=49,
                                          replays=2) * 49,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bound_by": "bytes", "bytes": nbytes,
                      "library_ms": None}
        print(f"epilogue_time {name} " + json.dumps(rows[name]), flush=True)
    torch.cuda.empty_cache()
    return rows


def matmul_bf16_bound(m, k, n):
    """(bound_ms, bytes, flops): bf16 x and w, f32 bias and output, read
    or written once; 2MNK operations at the bf16 tensor-core peak."""
    nbytes = 2 * (m * k + k * n) + 4 * (n + m * n)
    flops = 2 * m * n * k
    return (max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3,
            nbytes, flops)


def matmul_bf16_phase():
    """The bf16 kernel 9 against its plain version (the AMP program's
    unfused chain: the product rounded to bf16, the f32 bias added, the
    act in f32) at every shape and act: the products are summed in
    another order, so a product may round the other way: every output
    within one bf16 ulp of its product times the act's largest slope
    (MATMUL_BF16_SLOPE x 2^-7 |x @ w|), plus f32 noise, and the share of
    outputs not bit-equal reported.  A bf16 bias (bf16 output) once.
    Then times against the bound, the plain version and ``torch.addmm``
    in bf16 plus the act; the four calls of one AMP LeNet step together.
    Returns (max abs err, the LeNet step's row, the BERT FFN row)."""
    import torch

    from paddle_tpu_torch.ops import matmul_epilogue as me
    from paddle_tpu_torch.ops.bn_act import ACTS, apply_act

    def bf16_set(m, k, n, seed):
        x, w, b = matmul_inputs(m, k, n, seed)
        return x.bfloat16(), w.bfloat16(), b, b.bfloat16()

    err = 0.0
    sets, rows = {}, {}
    for name, m, k, n, acts in MATMUL_SHAPES:
        nbytes = matmul_bf16_bound(m, k, n)[1]
        count = max(2, min(200, -(-COLD_BYTES // nbytes)))
        sets[name] = [bf16_set(m, k, n, 300 + i) for i in range(count)]
        x, w, b, b16 = sets[name][0]
        row = {"shape": name, "M": m, "K": k, "N": n}
        prod = (x.float() @ w.float()).abs()     # TF32 off: full f32
        for act in acts or ACTS:
            got = me.matmul_bias_act(x, w, b, act)
            want = me.matmul_bias_act_reference(x, w, b, act)
            torch.cuda.synchronize()
            if got.dtype != torch.float32:
                fail(f"matmul_bias_act_bf16 {name}: output {got.dtype}")
            off = ulps_off(got, want)
            bound = (MATMUL_BF16_SLOPE * 2.0 ** -7 * prod
                     + 1e-6 * want.abs() + 1e-7)
            if not (torch.isfinite(got).all()
                    and bool(((got - want).abs() <= bound).all())):
                fail(f"matmul_bias_act_bf16 {name} act {act!r}: an output "
                     f"beyond one bf16 ulp of its product "
                     f"({off:.2f} ulps of the largest output)")
            row[f"ulps {act or 'none'}"] = off
            row[f"unequal {act or 'none'}"] = float(
                (got != want).float().mean())
            err = max(err, float((got - want).abs().max()))
            del got, want
        got = me.matmul_bias_act(x, w, b16, "relu")
        want = me.matmul_bias_act_reference(x, w, b16, "relu")
        torch.cuda.synchronize()
        # one ulp of the product, and the bf16 sum's own rounding
        bound = 2.0 ** -7 * prod + 2.0 ** -8 * want.float().abs()
        if got.dtype != torch.bfloat16 or not bool(
                ((got.float() - want.float()).abs() <= bound).all()):
            fail(f"matmul_bias_act_bf16 {name} with a bf16 bias: "
                 f"{got.dtype}, {ulps_off(got, want):.2f} ulps off")
        del prod
        act = (acts or ("relu",))[0]
        per_graph = max(len(sets[name]), 4)
        replays = 3 if m * n * k > 1e9 else 10
        bound_ms, nbytes, flops = matmul_bf16_bound(m, k, n)
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
        rows[name] = row
        print("matmul_case_bf16 " + json.dumps(row), flush=True)
        if m * n * k > 1e9:
            del sets[name]
            torch.cuda.empty_cache()
    args = [(*sets[name][i % len(sets[name])], act)
            for i in range(64) for name, act in LENET_STEP_CALLS]
    n_step = len(LENET_STEP_CALLS)
    step = {"calls_per_step": n_step,
            "bound_ms": sum(matmul_bf16_bound(rows[nm]["M"], rows[nm]["K"],
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
    print("matmul_lenet_step_bf16 " + json.dumps(step), flush=True)
    del sets
    torch.cuda.empty_cache()
    return err, step, rows["bert-ffn-in"]


def resnet_amp_phase(torch):
    """ResNet-50 under ``decorate(MomentumOptimizer)``, the example's
    default, NHWC by ``FLAGS_cuda_nhwc=auto``: 2 warm-up and 10 timed
    steps; every loss finite and the last below the first, each bf16
    epilogue kernel launched 49 times per step and no f32 one, the
    convolutions' Input channels-last.  Returns the bf16 epilogue
    kernels' launches."""
    from paddle_tpu_torch.ops import bn_act as ba
    from paddle_tpu_torch.tools.train_resnet import train

    kernels = {"bn_act_apply_bf16": ba.BN_ACT_APPLY_BF16,
               "bn_act_bwd_bf16": ba.BN_ACT_BWD_BF16,
               "bn_act_apply_f32": ba.BN_ACT_APPLY,
               "bn_act_bwd_f32": ba.BN_ACT_BWD}
    warmup, steps, batch = 2, 10, 128
    gc.collect()   # the step is host-bound: no collection of earlier phases
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    run = train(depth=50, batch=batch, image=224, classes=1000, steps=steps,
                lr=RESNET_LR, device="cuda", warmup=warmup, log_every=1,
                amp=True)
    torch.cuda.synchronize()
    launches = {n: kf.launches for n, kf in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = run["losses"]
    if not np.all(np.isfinite(losses)):
        fail(f"ResNet-50 AMP losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"ResNet-50 AMP loss did not fall: {losses}")
    n = 49 * (warmup + steps)
    want = {"bn_act_apply_bf16": n, "bn_act_bwd_bf16": n,
            "bn_act_apply_f32": 0, "bn_act_bwd_f32": 0}
    if launches != want:
        fail(f"ResNet-50 AMP epilogue launches {launches}: expected {want}")
    plan = next(p for key, p in run["executor"]._cache.items()
                if key[0] == run["program"]._uid)
    types = [o.type for o in plan.ops]
    fused = [o for o in plan.ops if o.type == "fused_conv_bn_act"]
    if (len(fused) != 49 or any(o.attrs.get("data_format") != "NHWC"
                                for o in fused)
            or "cast" not in types or "transpose2" not in types):
        fail(f"ResNet-50 AMP plan: {len(fused)} fused convs, formats "
             f"{sorted({o.attrs.get('data_format') for o in fused})}, "
             f"casts {types.count('cast')}, transposes "
             f"{types.count('transpose2')}")
    print("resnet_training_amp " + json.dumps({
        "model": "ResNet-50 AMP bf16 (decorate)", "batch": batch,
        "image": 224, "classes": 1000, "lr": RESNET_LR, "momentum": 0.9,
        "layout": "NHWC", "warmup_steps": warmup, "timed_steps": steps,
        "losses": losses, "acc1": run["acc1"],
        "ms_per_step": run["ms_per_step"],
        "images_per_s": run["images_per_s"],
        "max_memory_allocated": peak,
        "launches_per_step": {k: v / (warmup + steps)
                              for k, v in launches.items()},
        "casts": types.count("cast"), "transposes": types.count("transpose2"),
        "ops": len(types)}), flush=True)
    del run
    torch.cuda.empty_cache()
    return {k: v for k, v in launches.items() if k.endswith("_bf16")}


def rel_errs(got, want):
    """Per tensor: largest |got - want| over the largest |want|."""
    return {n: float(np.abs(got[n] - w).max())
            / max(float(np.abs(w).max()), 1e-12) for n, w in want.items()}


def resnet_amp_card_vs_cpu(torch):
    """The AMP ResNet-50 step at the oracle size (batch 4, 32x32, 100
    classes) from one startup scope, 3 steps on the card (NHWC, kernels)
    and on the CPU (NCHW, plain versions): step 1 within
    AMP_RESNET_STEP1_RTOL, every step finite, and the state after step 1
    (parameters, velocities, BN statistics) within the envelope of one
    more CPU step on images carrying bf16-sized noise."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.framework.scope import (Scope, load_numpy_state,
                                                  numpy_state)
    from paddle_tpu_torch.ops import bn_act as ba
    from paddle_tpu_torch.tools.train_resnet import build_program, make_batch

    main, startup, loss, _ = build_program(50, 32, 100, 0.01, amp=True)
    start = Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=start)
    names = [n for n, _ in start.items()]
    state = numpy_state(start, names)
    img, label = make_batch(4, 32, 100)
    losses, after1 = {}, {}
    launched = ba.BN_ACT_APPLY_BF16.launches
    for dev in ("cpu", "cuda"):
        scope = Scope()
        load_numpy_state(scope, state, dev)
        exe = fluid.Executor(fluid.CPUPlace() if dev == "cpu"
                             else fluid.CUDAPlace(0))
        losses[dev] = []
        for step in range(3):
            losses[dev].append(float(exe.run(
                main, feed={"img": img, "label": label}, fetch_list=[loss],
                scope=scope)[0]))
            if step == 0:
                after1[dev] = numpy_state(scope, names)
    if ba.BN_ACT_APPLY_BF16.launches != launched + 49 * 3:
        fail("ResNet AMP card vs CPU: the card's run did not launch the "
             "bf16 epilogue kernels")
    scope = Scope()
    load_numpy_state(scope, state, "cpu")
    noisy = img * (1 + AMP_RESNET_NOISE * np.random.RandomState(1).randn(
        *img.shape))
    twin = float(fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"img": noisy.astype(np.float32), "label": label},
        fetch_list=[loss], scope=scope)[0])
    errs = rel_errs(after1["cuda"], after1["cpu"])
    env = rel_errs(numpy_state(scope, names), after1["cpu"])
    cpu1 = losses["cpu"][0]
    envelope = abs(twin - cpu1) / abs(cpu1)
    rtol = AMP_RESNET_STEP1_RTOL
    rel = abs(cpu1 - losses["cuda"][0]) / abs(cpu1)
    groups = {}
    for gname, pick in (("velocities", lambda n: "velocity" in n),
                        ("other_state", lambda n: "velocity" not in n)):
        got = [e for n, e in errs.items() if pick(n)]
        ref = [e for n, e in env.items() if pick(n)]
        groups[gname] = {"tensors": len(got), "worst": max(got),
                         "median": float(np.median(got)),
                         "twin_worst": max(ref),
                         "twin_median": float(np.median(ref))}
    print("resnet_amp_card_vs_cpu " + json.dumps({
        **losses, "step1_rel_diff": rel, "cpu_noise_step1_rel": envelope,
        "rtol": rtol, "after_step1": groups}), flush=True)
    if not np.all(np.isfinite(losses["cuda"])):
        fail(f"ResNet AMP card vs CPU: card losses not finite {losses}")
    if not rel <= rtol:
        fail(f"ResNet AMP card vs CPU step-1 losses differ by {rel:.3e} > "
             f"{rtol:.3e}")
    for gname, g in groups.items():
        if not (g["worst"] <= 2 * g["twin_worst"]
                and g["median"] <= 2 * g["twin_median"]):
            fail(f"ResNet AMP card vs CPU after step 1, {gname}: {g} "
                 f"outside twice the noisy twin's envelope")


def book_amp_phase(torch, model, chains, act):
    """One book model under ``decorate`` at its tool defaults, 5 warm-up
    and 30 timed steps: losses finite and falling, the chains fused, the
    bf16 kernel 9 launched 2 x chains per step and the f32 one never.
    Returns the bf16 kernel's launches."""
    from paddle_tpu_torch.ops.matmul_epilogue import (MATMUL_BIAS_ACT_BF16,
                                                      MATMUL_BIAS_ACT_F32)
    from paddle_tpu_torch.tools.train_book import DEFAULTS, train

    warmup, steps = 5, 30
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    MATMUL_BIAS_ACT_BF16.launches = MATMUL_BIAS_ACT_F32.launches = 0
    run = train(model, DEFAULTS[model], steps=steps, device="cuda",
                warmup=warmup, log_every=5, amp=True)
    torch.cuda.synchronize()
    launches = MATMUL_BIAS_ACT_BF16.launches
    f32 = MATMUL_BIAS_ACT_F32.launches
    peak = torch.cuda.max_memory_allocated()
    losses = run["losses"]
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{model} AMP losses {losses} not finite or not falling")
    plan = next(p for key, p in run["executor"]._cache.items()
                if key[0] == run["program"]._uid)
    fused = [o for o in plan.ops if o.type == "fused_matmul_bias_act"]
    grads = [o for o in plan.ops if o.type == "fused_matmul_bias_act_grad"]
    if (len(fused), len(grads)) != (chains, chains) or any(
            o.attrs["act_type"] != act for o in fused):
        fail(f"{model} AMP: {len(fused)} fused_matmul_bias_act and "
             f"{len(grads)} grads, expected {chains} each with act {act!r}")
    n = 2 * chains * (warmup + steps)
    if launches != n or f32:
        fail(f"{model} AMP: matmul_bias_act_bf16 launched {launches} times "
             f"(expected {n}), the f32 kernel {f32} times (expected 0)")
    print(f"{model}_training_amp " + json.dumps({
        "model": f"{model} AMP bf16 (decorate)", **DEFAULTS[model],
        "warmup_steps": warmup, "timed_steps": steps, "losses": losses,
        "acc": run["acc"], "ms_per_step": run["ms_per_step"],
        "examples_per_s": run["examples_per_s"],
        "max_memory_allocated": peak,
        "launches_per_step": launches / (warmup + steps),
        "fused_chains": len(fused)}), flush=True)
    del run
    torch.cuda.empty_cache()
    return launches


def lenet_amp_card_vs_cpu(torch):
    """``bench.py:_lenet_losses``'s run under ``decorate`` on the card
    and on the CPU from one startup scope, 12 steps."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.framework.scope import (Scope, load_numpy_state,
                                                  numpy_state)
    from paddle_tpu_torch.ops.matmul_epilogue import MATMUL_BIAS_ACT_BF16
    from paddle_tpu_torch.tools.train_book import build_program

    steps = 12
    main, startup, fetch = build_program("lenet", {"batch": 64, "lr": 0.05},
                                         seed=5, amp=True)
    start = Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=start)
    state = numpy_state(start, [n for n, _ in start.items()])
    rng = np.random.RandomState(7)
    feed = {"img": rng.rand(64, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (64, 1)).astype(np.int64)}
    losses = {}
    launched = MATMUL_BIAS_ACT_BF16.launches
    for dev in ("cpu", "cuda"):
        scope = Scope()
        load_numpy_state(scope, state, dev)
        exe = fluid.Executor(fluid.CPUPlace() if dev == "cpu"
                             else fluid.CUDAPlace(0))
        losses[dev] = [float(exe.run(main, feed=feed, fetch_list=fetch[:1],
                                     scope=scope)[0]) for _ in range(steps)]
    if MATMUL_BIAS_ACT_BF16.launches != launched + 4 * steps:
        fail("LeNet AMP card vs CPU: the card's run did not launch the "
             "bf16 kernel 9 4 times per step")
    cpu, card = np.asarray(losses["cpu"]), np.asarray(losses["cuda"])
    rel1 = abs(card[0] - cpu[0]) / abs(cpu[0])
    worst = float(np.abs(card - cpu).max())
    print("lenet_amp_card_vs_cpu " + json.dumps({
        **losses, "step1_rel_diff": rel1, "step1_rtol": AMP_LENET_STEP1_RTOL,
        "max_abs_diff": worst, "atol": AMP_LENET_LOSS_ATOL}), flush=True)
    if not np.all(np.isfinite(card)):
        fail(f"LeNet AMP card vs CPU: card losses not finite {losses}")
    if not (rel1 <= AMP_LENET_STEP1_RTOL and worst <= AMP_LENET_LOSS_ATOL):
        fail(f"LeNet AMP card vs CPU: step 1 {rel1:.3e} relative (tolerance "
             f"{AMP_LENET_STEP1_RTOL}), worst step {worst:.3e} absolute "
             f"(tolerance {AMP_LENET_LOSS_ATOL})")


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


def make_quant_case(rng, dtype, hq, hkv, d, ps, n_pages, ctx_lens, n_pad=0):
    """``make_decode_case``'s tables and lengths over bf16 pools, or int8
    pools (codes in [-127, 127]) with their f32 scale pools."""
    import torch

    q, k, v, tables, ctx = make_decode_case(rng, hq, hkv, d, ps, n_pages,
                                            ctx_lens, n_pad)
    if dtype == "bfloat16":
        return (q, k.bfloat16(), v.bfloat16(), tables, ctx), ()
    del k, v
    codes = [torch.randint(-127, 128, (hkv, n_pages, ps, d), device="cuda",
                           dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand(hkv, n_pages, device="cuda") * 2 + 0.1
              for _ in range(2)]
    return (q, *codes, tables, ctx), tuple(scales)


def quant_bound(case, scales):
    """(bound_ms, bound_by): the live K/V rows at the pool's element size,
    the live pages' scales (int8), q, out, tables and lengths over HBM
    bandwidth, against the f32 operations over the f32 peak."""
    q, k, _, tables, ctx = case
    b, hq, d = q.shape
    hkv, _, ps, _ = k.shape
    tokens = int(ctx.sum())
    nbytes = (2 * tokens * hkv * d * k.element_size() + 2 * q.numel() * 4
              + tables.numel() * 4 + ctx.numel() * 4)
    if scales:
        nbytes += 2 * hkv * 4 * int(((ctx + ps - 1) // ps).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * d * hq * tokens / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def quant_library_inputs(case, scales, dtype):
    """SDPA's inputs: bf16 q, K and V gathered dense for a bf16 pool; for
    int8 (no PyTorch call takes int8 pages and scales) the K/V
    dequantized to f32 beforehand, f32 q."""
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


def check_and_time_quant(name, dtype, rng, hq, hkv, d, ps, n_pages,
                         ctx_lens, n_pad=0):
    """One pool dtype's kernel at one shape: against its plain version on
    the same CUDA tensors (both dequantize as ``code * (scale / 127)``,
    so only the order of the sums differs: KERNEL_ATOL), then timed by
    CUDA-graph replay over enough input sets to keep the L2 cold."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import paged_attention as pa

    esize = 2 if dtype == "bfloat16" else 1
    live = 2 * sum(ctx_lens) * hkv * d * esize
    n_sets = max(4, -(-COLD_BYTES // live) + 1)
    cases = [make_quant_case(rng, dtype, hq, hkv, d, ps, n_pages, ctx_lens,
                             n_pad) for _ in range(n_sets)]
    scale = d ** -0.5
    kernel = pa.paged_decode_bf16 if dtype == "bfloat16" else \
        pa.paged_decode_int8
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
    args = [(*c, *sc) for c, sc in cases]
    ms = time_ms(lambda *a: kernel(*a[:5], scale, *a[5:]), args)
    plain_ms = time_ms(lambda *a: pa.paged_attention_reference(
        *a[:5], scale, *a[5:]), args)
    lib_sets = [quant_library_inputs(c, sc, dtype) for c, sc in cases[:4]]
    lib_ms = time_ms(lambda q, kd, vd, m: F.scaled_dot_product_attention(
        q, kd, vd, attn_mask=m, scale=scale), lib_sets)
    bound_ms, bound_by = quant_bound(*cases[0])
    row = {"shape": name, "dtype": dtype, "B": len(cases[0][0][4]), "Hq": hq,
           "Hkv": hkv, "D": d, "page_size": ps,
           "width": int(cases[0][0][3].shape[1]), "input_sets": n_sets,
           "ctx": [int(x) for x in cases[0][0][4].tolist()],
           "max_abs_err": err, "tolerance": KERNEL_ATOL, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": lib_ms,
           "library": ("sdpa_bf16_dense" if dtype == "bfloat16" else
                       "sdpa_f32_dense_predequantized")}
    print("kernel_case_quant " + json.dumps(row), flush=True)
    del cases, args, lib_sets
    torch.cuda.empty_cache()
    return row


def quant_kernel_phase():
    rows = {}
    for dtype, kname in QUANT_ROWS:
        rng = np.random.RandomState(0)
        serving = check_and_time_quant(
            "serving", dtype, rng, hq=12, hkv=12, d=64, ps=16, n_pages=1024,
            ctx_lens=[1024, 777, 512, 301, 64, 17], n_pad=2)
        gqa = check_and_time_quant(
            "gqa", dtype, rng, hq=32, hkv=8, d=128, ps=16, n_pages=1024,
            ctx_lens=[1, 16, 33, 250, 512, 700, 1000, 1024])
        rows[kname] = {**serving, "max_abs_err": max(serving["max_abs_err"],
                                                     gqa["max_abs_err"])}
    return rows


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


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False   # the reference is full f32
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs accumulate in f32 throughout, as the JAX package's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    from paddle_tpu_torch.ops.flash_attention import FLASH
    from paddle_tpu_torch.ops.gelu import GELU
    from paddle_tpu_torch.ops.matmul_epilogue import (
        MATMUL_BIAS_ACT, MATMUL_BIAS_ACT_BF16_LIB)
    from paddle_tpu_torch.ops.paged_attention import PAGED_ATTENTION

    phase("build")
    kernels = [PAGED_ATTENTION, FLASH, BN_ACT, MATMUL_BIAS_ACT,
               MATMUL_BIAS_ACT_BF16_LIB, GELU]
    kernel_build.build_all(kernels)
    for k in kernels:
        print(f"built {k.source} in {k.build_seconds:.2f} s", flush=True)
        for ln in k.build_log.splitlines():
            if ("registers" in ln or "spill" in ln or "error" in ln
                    or "Compiling entry" in ln):
                print("  ptxas: " + ln.strip())

    phase("paged decode: kernel vs plain version, times")
    rng = np.random.RandomState(0)
    # the serving shape: GPT-2 small heads, 6 live sequences with ragged
    # lengths (page boundaries among them) and 2 bucket-padding rows
    serving = check_and_time_kernel(
        "serving", rng, hq=12, hkv=12, d=64, ps=16, n_pages=1024,
        ctx_lens=[1024, 777, 512, 301, 64, 17], n_pad=2)
    gqa = check_and_time_kernel(
        "gqa", rng, hq=32, hkv=8, d=128, ps=16, n_pages=1024,
        ctx_lens=[1, 16, 33, 250, 512, 700, 1000, 1024])

    phase("flash attention: kernels vs plain versions, times")
    flash_errs, flash_times = flash_phase()

    phase("training: BERT-base f32, then seq 2048")
    flash_launches = train_phase(torch)

    phase("training: card vs CPU, 2 layers at full width")
    f32_losses = card_vs_cpu(torch)

    phase("a/b. flash attention bf16: kernels vs plain versions, times")
    flash16_errs, flash16_times = flash_bf16_phase()

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
    epi16_errs, epi16_sets = check_epilogue_bf16()
    epi16_times = time_epilogue_bf16(epi16_sets)
    del epi16_sets
    torch.cuda.empty_cache()

    phase("g. training: ResNet-50 static AMP (bf16, NHWC), batch 128")
    epi16_launches = resnet_amp_phase(torch)

    phase("h. training: ResNet-50 AMP card vs CPU, batch 4, 32x32")
    resnet_amp_card_vs_cpu(torch)

    phase("i. matmul epilogue bf16: kernel vs plain version, times")
    mm16_err, mm16_step, _ = matmul_bf16_phase()

    phase("j. training: LeNet and word2vec static AMP (bf16), batch 256")
    mm16_launches = book_amp_phase(torch, "lenet", 2, "relu")
    mm16_launches += book_amp_phase(torch, "word2vec", 1, "sigmoid")

    phase("k. training: LeNet AMP card vs CPU, batch 64, 12 steps")
    lenet_amp_card_vs_cpu(torch)

    phase("l. paged decode bf16 / int8: kernels vs plain versions, times")
    quant_rows = quant_kernel_phase()

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

    rows = [{
        "name": "paged_decode_f32", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:845",
        "launches": launches,
        "max_abs_err": max(serving["max_abs_err"], gqa["max_abs_err"]),
        "ms": serving["ms"], "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"], "bound_by": serving["bound_by"],
        "library_ms": serving["library_ms"]}]
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
    for name, replaces in FLASH_BF16_ROWS:
        # each at the shape the AMP O1 training path launches it at
        t = flash16_times[MAIN_PATH_SHAPE[name]][name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "launches": flash16_launches[name],
            "max_abs_err": flash16_errs[name], "ms": t["ms"],
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
        "source": "paddle_tpu_torch/csrc/matmul_bias_act_bf16.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:1186",
        "launches": mm16_launches, "max_abs_err": mm16_err,
        "ms": mm16_step["ms"], "plain_ms": mm16_step["plain_ms"],
        "bound_ms": mm16_step["bound_ms"],
        "bound_by": mm16_step["bound_by"],
        "library_ms": mm16_step["library_ms"]})
    # the bf16 gelu of the AMP O2 path (no Pallas kernel: XLA fuses the
    # JAX lowering); bit-equal to its plain versions
    for name, replaces in GELU_ROWS:
        t = gelu_times[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/gelu_bf16.cu",
            "replaces": replaces, "launches": gelu_launches[name],
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
