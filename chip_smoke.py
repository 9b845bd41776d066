#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. device: the ``nvidia-smi`` name and power limit; compute capability
   must be (9, 0);
2. build: every kernel of the serving path built by ``nvcc`` from the
   sources in this checkout (one ``nvcc`` per source, all at once);
3. kernel vs plain version: the paged-decode kernel against its plain
   PyTorch version on the card, at the serving shape and a GQA shape;
4. kernel times (calls captured in a CUDA graph, replayed between CUDA
   events after warm-up; inputs rotated through enough copies to keep
   the 50 MB L2 cold, as in a 12-layer decode step):
   kernel, plain version, the bound of the bytes the live K/V rows need,
   and ``scaled_dot_product_attention`` over gathered dense K/V as a
   library yardstick (the port never calls it);
5. serving: ``ServingEngine`` at GPT-2-small widths (12 layers, random
   weights from seed 0) serves 16 requests; every request must finish,
   the kernel's launch count must equal layers x decode steps, and two
   requests must match the full-recompute greedy reference;
6. the last line: ``{"ok": true, "device": {...}}``.

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
    from paddle_tpu_torch.ops.paged_attention import PAGED_DECODE

    phase("build")
    kernels = [PAGED_DECODE]
    kernel_build.build_all(kernels)
    for k in kernels:
        print(f"built {k.source} in {k.build_seconds:.2f} s", flush=True)
        for ln in k.build_log.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln:
                print("  ptxas: " + ln.strip())

    phase("kernel vs plain version, times")
    rng = np.random.RandomState(0)
    # the serving shape: GPT-2 small heads, 6 live sequences with ragged
    # lengths (page boundaries among them) and 2 bucket-padding rows
    serving = check_and_time_kernel(
        "serving", rng, hq=12, hkv=12, d=64, ps=16, n_pages=1024,
        ctx_lens=[1024, 777, 512, 301, 64, 17], n_pad=2)
    gqa = check_and_time_kernel(
        "gqa", rng, hq=32, hkv=8, d=128, ps=16, n_pages=1024,
        ctx_lens=[1, 16, 33, 250, 512, 700, 1000, 1024])

    phase("serving")
    launches = serve(torch)

    print(json.dumps({"kernels": [{
        "name": "paged_decode_f32", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:845",
        "launches": launches,
        "max_abs_err": max(serving["max_abs_err"], gqa["max_abs_err"]),
        "ms": serving["ms"], "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"], "bound_by": serving["bound_by"],
        "library_ms": serving["library_ms"]}]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
