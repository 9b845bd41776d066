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
   all at once), with ``ptxas``'s register and spill lines;
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
   (kernels) and on the CPU (plain versions) within rtol 1e-4;
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
    49 shapes one training step gives it, and both timed over those 49
    calls (CUDA-graph replay, every call on its own tensors, so the L2 is
    cold), against the byte bound of those calls;
11. ResNet-50 static training: ``examples/train_resnet_static.py``'s
    configuration (vB bottlenecks [3, 4, 6, 3], 224x224, 1000 classes,
    batch 128, Momentum 0.9, weights from the startup program, one batch
    from numpy seed 0) in float32, at a tenth of the example's rate
    (``MomentumOptimizer(0.01, 0.9)``; at 0.1 momentum on one repeated
    batch overshoots after two steps and where the twelfth step lands
    varies run to run), through ``fluid`` and ``Executor(CUDAPlace(0))``
    with the fusion flag at auto: 2 warm-up and 10 timed steps; every
    loss finite, the last below the first, each epilogue kernel launched
    exactly 49 times per step, every scope tensor on the card;
12. ResNet card vs CPU: ResNet-50 at batch 4, 32x32, 100 classes from
    one startup scope on the card and on the CPU: step-1 losses within
    1e-4 relative, later steps finite;
13. the ``kernels`` line, the card's name and power limit, and the last
    line: ``{"ok": true, "device": {...}}``.

The port is imported only after the device check, so run without the
rest of the repository, or without a CUDA device, it fails.
"""
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
LOSS_RTOL = 1e-4
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
# a served token may differ from the reference only where the
# reference's top-2 logit margin is below this (f32 rounding of two
# different compositions of the same model)
TIE_MARGIN = 1e-3


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def phase(name: str):
    print(f"== {name}", flush=True)


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


def serve(torch):
    from paddle_tpu_torch.inference.serving import (
        DecoderConfig, Request, ServingEngine, init_decoder_weights)
    from paddle_tpu_torch.ops.paged_attention import PAGED_DECODE

    # GPT-2 small widths (openai-community/gpt2 config.json)
    cfg = DecoderConfig(vocab_size=50257, hidden=768, num_heads=12,
                        num_layers=12, max_seq_len=1024)
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, init_decoder_weights(cfg, 0), num_pages=1024,
                        page_size=16, max_batch=8, token_budget=1024,
                        device="cuda")
    print(f"engine set-up {time.perf_counter() - t0:.3f} s "
          f"(weights {sum(p.numel() for p in eng.core.model.parameters())} "
          f"f32, KV pools {eng.core.kv_pool_resident_bytes()} B)",
          flush=True)
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
    PAGED_DECODE.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = PAGED_DECODE.launches
    core.prefill, core.decode_batch = prefill_fn, decode_fn
    peak = torch.cuda.max_memory_allocated()

    done = [r for r in reqs if r.finished_at is not None
            and len(r.out_tokens) == r.max_new_tokens]
    if len(done) != len(reqs):
        fail(f"{len(reqs) - len(done)} of {len(reqs)} requests unfinished")
    steps = eng.stats["decode_steps"] - steps0
    if launches != cfg.num_layers * steps:
        fail(f"paged-decode launches {launches} != layers {cfg.num_layers}"
             f" x decode steps {steps}")
    n_tok = sum(len(r.out_tokens) for r in reqs)
    report = {"requests": len(reqs), "prompt_tokens": int(lens.sum()),
              "generated_tokens": n_tok, "wall_s": elapsed,
              "tokens_per_s": n_tok / elapsed,
              "decode_steps": steps,
              "decode_ms_per_step": wall["decode"] / steps * 1e3,
              "prefill_ms_total": wall["prefill"] * 1e3,
              "prefill_ms_per_request": wall["prefill"] / len(reqs) * 1e3,
              "preempted": eng.stats["preempted"],
              "max_memory_allocated": peak, "paged_decode_launches": launches}

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
                fail(f"request {r.req_id} diverges from the reference at "
                     f"token {i} with top-2 margin {margin:.3e} >= "
                     f"{TIE_MARGIN}")
        checked.append(row)
    report["reference_check"] = checked
    report["tie_margin_tolerance"] = TIE_MARGIN
    print("serving " + json.dumps(report), flush=True)
    return launches


# ==========================================================================
# flash attention: kernels vs plain versions, times
# ==========================================================================
FLASH_ROWS = (  # (kernel name, TPU kernel it replaces)
    ("flash_fwd_f32", "paddle_tpu/ops/pallas_kernels.py:203"),
    ("flash_bwd_fused_f32", "paddle_tpu/ops/pallas_kernels.py:449"),
    ("flash_bwd_dq_f32", "paddle_tpu/ops/pallas_kernels.py:386"),
    ("flash_bwd_dkv_f32", "paddle_tpu/ops/pallas_kernels.py:413"),
)
EPILOGUE_ROWS = (  # (kernel name, TPU kernel it replaces)
    ("bn_act_apply_f32", "paddle_tpu/ops/pallas_kernels.py:1039"),
    ("bn_act_bwd_f32", "paddle_tpu/ops/pallas_kernels.py:1131"),
)
# the timing case the training path launches each kernel at: the backward
# takes the fused kernel at seq 512 and the split pair at seq 2048
MAIN_PATH_SHAPE = {"flash_fwd_f32": "bert", "flash_bwd_fused_f32": "bert",
                   "flash_bwd_dq_f32": "long", "flash_bwd_dkv_f32": "long"}


def flash_kernels():
    from paddle_tpu_torch.ops import flash_attention as fa

    return {kf.name: kf for kf in (fa.FLASH_FWD, fa.FLASH_BWD_FUSED,
                                   fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV)}


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
    once over HBM bandwidth, against the f32 flops the function needs
    (per attended pair and head dim: forward 4, dQ 6 [S, dP, dS K],
    dK/dV 8 [S, dP, dS^T Q, P^T dO], fused 10) over the f32 peak."""
    q, k, _, _, bias = case
    b, h, sq, d = q.shape
    sk = k.shape[2]
    qn, kn, rows = q.numel(), k.numel(), b * h * sq
    bias_n = 0 if bias is None else bias.numel()
    elems = {   # (elements read, elements written), f32
        "flash_fwd_f32": (qn + 2 * kn + bias_n, qn + rows),
        "flash_bwd_fused_f32": (2 * qn + 2 * kn + 2 * rows + bias_n,
                                qn + 2 * kn),
        "flash_bwd_dq_f32": (2 * qn + 2 * kn + 2 * rows + bias_n, qn),
        "flash_bwd_dkv_f32": (2 * qn + 2 * kn + 2 * rows + bias_n, 2 * kn),
    }[name]
    per_pair = {"flash_fwd_f32": 4, "flash_bwd_fused_f32": 10,
                "flash_bwd_dq_f32": 6, "flash_bwd_dkv_f32": 8}[name]
    flops = per_pair * d * attended_pairs(b, h, sq, sk, causal)
    t_bytes = 4 * sum(elems) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
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


def time_flash(name, cases, causal, rate):
    """ms, plain_ms, library_ms and the bound of every flash kernel on
    ``cases`` (copies of one shape, rotated to keep the L2 cold)."""
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
        sets.append((q, k, v, do, bias, keep, out, lse, (do * out).sum(-1)))
    kern = {
        "flash_fwd_f32": lambda q, k, v, do, bias, keep, out, lse, delta:
            fa.flash_fwd(q, k, v, bias, scale, causal, rate, seed),
        "flash_bwd_fused_f32": lambda q, k, v, do, bias, keep, out, lse,
            delta: fa.bwd_fused(q, k, v, bias, do, lse, delta, scale,
                                causal, rate, seed),
        "flash_bwd_dq_f32": lambda q, k, v, do, bias, keep, out, lse, delta:
            fa.bwd_dq(q, k, v, bias, do, lse, delta, scale, causal, rate,
                      seed),
        "flash_bwd_dkv_f32": lambda q, k, v, do, bias, keep, out, lse,
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
        mask = None if bias is None else bias[:, None, None, :]
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
        fwd = kname == "flash_fwd_f32"
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
                device="cuda", pad=True, warmup=warmup, log_every=1)
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
                     warmup=1, log_every=1)
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
    on the CPU from the same weights, 3 Adam steps."""
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


# ==========================================================================
# the conv epilogue kernels, and ResNet-50 static training
# ==========================================================================
def resnet50_epilogue_shapes():
    """[(conv-output shape, has z)] of the 49 fused_conv_bn_act ops of the
    ResNet-50 training program at batch 128, 224x224, in program order."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.tools.train_resnet import build_program
    from paddle_tpu_torch.utils import flags

    prev = flags.get_flag("FLAGS_cuda_fuse")
    flags.set_flags({"FLAGS_cuda_fuse": "1"})
    try:
        main, _, loss, acc1 = build_program(50, 224, 1000)
        rew = fluid.Executor("cpu")._apply_ir_passes(main, [loss.name,
                                                            acc1.name])
    finally:
        flags.set_flags({"FLAGS_cuda_fuse": prev})
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


def epilogue_bytes(shape, with_z, bwd):
    """Bytes each call must move: every input read once, every output
    written once (f32): forward x (and z) in, y out; backward y, dy, x in,
    dx (and g) out; plus the per-channel vectors."""
    n = int(np.prod(shape))
    c = shape[1]
    if bwd:
        return 4 * (n * (4 + with_z) + 4 * c)
    return 4 * (n * (2 + with_z) + 2 * c)


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
                if not torch.equal(dx, rdx) or (want_g and
                                                 not torch.equal(g, rg)):
                    fail(f"bn_act_bwd_f32 {name} act {act!r} want_g "
                         f"{want_g}: not equal to the plain version "
                         f"(max |err| {float((dx - rdx).abs().max()):.3e})")
                row[f"bwd {act or 'none'}{' g' if want_g else ''}"] = 0.0
                del dx, g, rdx, rg
        print("epilogue_check " + json.dumps(row), flush=True)
        del x, z, y
        torch.cuda.empty_cache()
    return errs


def time_epilogue():
    """Each kernel against its plain version (bit for bit, relu) at
    every one of the 49 shapes one ResNet-50 training step gives it, then
    both timed over those 49 calls (every call on its own tensors) by
    CUDA-graph replay; with the byte bound of those calls and the two
    largest shapes' own rows.  Returns {kernel: row}."""
    import torch

    from paddle_tpu_torch.ops import bn_act as ba

    shapes = resnet50_epilogue_shapes()
    if len(shapes) != 49:
        fail(f"the ResNet-50 program has {len(shapes)} fused conv chains, "
             f"expected 49")
    fwd_sets, bwd_sets = [], []
    for i, (shape, with_z) in enumerate(shapes):
        x, z, (a, b, mean, cx) = epilogue_inputs(shape, with_z, 100 + i)
        fwd_sets.append((x, a, b, z))
        y = torch.relu(x)
        bwd_sets.append((y, torch.randn_like(x), x, a, mean, cx, b,
                         with_z))
    rows = {}
    for name, sets, kern, plain, bwd in (
            ("bn_act_apply_f32", fwd_sets,
             lambda x, a, b, z: ba.bn_act_apply(x, a, b, z, "relu"),
             lambda x, a, b, z: ba.bn_act_apply_reference(x, a, b, z,
                                                          "relu"), False),
            ("bn_act_bwd_f32", bwd_sets,
             lambda y, dy, x, cg, m, cx, c0, wg: ba.bn_act_bwd_apply(
                 y, dy, x, cg, m, cx, c0, "relu", 1, wg),
             lambda y, dy, x, cg, m, cx, c0, wg: ba.bn_act_bwd_reference(
                 y, dy, x, cg, m, cx, c0, "relu", 1, wg), True)):
        for (shape, _), args in zip(shapes, sets):   # every path shape
            got, want = kern(*args), plain(*args)
            if bwd:
                same = torch.equal(got[0], want[0]) and (
                    got[1] is None or torch.equal(got[1], want[1]))
            else:
                same = torch.equal(got, want)
            if not same:
                fail(f"{name} differs from its plain version at {shape}")
            del got, want
        nbytes = sum(epilogue_bytes(s, z, bwd) for s, z in shapes)
        step_ms = time_ms(kern, sets, per_graph=49, replays=5) * 49
        plain_ms = time_ms(plain, sets, per_graph=49, replays=2) * 49
        largest = {}
        for shape, with_z in {(s, z) for s, z in shapes
                              if s[1] * s[2] * s[3] == 64 * 112 * 112
                              or s[1] * s[2] * s[3] == 256 * 56 * 56}:
            idx = [i for i, (s, z) in enumerate(shapes)
                   if (s, z) == (shape, with_z)]
            one = [sets[i] for i in idx]
            largest[f"{list(shape)}{' z' if with_z else ''}"] = {
                "calls_per_step": len(idx),
                "ms": time_ms(kern, one, per_graph=max(len(one), 4),
                              replays=5),
                "bound_ms": epilogue_bytes(shape, with_z, bwd)
                / HBM_BYTES_PER_S * 1e3}
        rows[name] = {"calls": len(shapes), "ms": step_ms,
                      "plain_ms": plain_ms,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bound_by": "bytes", "bytes": nbytes,
                      "library_ms": None, "largest_shapes": largest}
        print(f"epilogue_time {name} " + json.dumps(rows[name]), flush=True)
    del fwd_sets, bwd_sets
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
                lr=RESNET_LR, device="cuda", warmup=warmup, log_every=1)
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
    off = [name for name, t in run["scope"].items()
           if not (isinstance(t, torch.Tensor) and t.device.type == "cuda")]
    if off:
        fail(f"scope vars not on the card: {off[:5]}")
    print("resnet_training " + json.dumps({
        "model": "ResNet-50 f32", "batch": batch, "image": 224,
        "classes": 1000, "lr": RESNET_LR, "momentum": 0.9,
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

    main, startup, loss, _ = build_program(50, 32, 100, 0.01)
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


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False   # the reference is full f32
    torch.backends.cudnn.allow_tf32 = False
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
    from paddle_tpu_torch.ops.paged_attention import PAGED_ATTENTION

    phase("build")
    kernels = [PAGED_ATTENTION, FLASH, BN_ACT]
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
    card_vs_cpu(torch)

    phase("serving")
    launches = serve(torch)

    phase("conv epilogue: kernels vs plain versions, times")
    epi_errs = check_epilogue()
    epi_times = time_epilogue()

    phase("training: ResNet-50 static, f32, batch 128, 224x224")
    epi_launches = resnet_phase(torch)

    phase("training: ResNet-50 card vs CPU, batch 4, 32x32")
    resnet_card_vs_cpu(torch)

    rows = [{
        "name": "paged_decode_f32", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:845",
        "launches": launches,
        "max_abs_err": max(serving["max_abs_err"], gqa["max_abs_err"]),
        "ms": serving["ms"], "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"], "bound_by": serving["bound_by"],
        "library_ms": serving["library_ms"]}]
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
    for name, replaces in EPILOGUE_ROWS:
        t = epi_times[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/bn_act.cu",
            "replaces": replaces, "launches": epi_launches[name],
            "max_abs_err": epi_errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
