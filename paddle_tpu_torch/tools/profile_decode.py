"""Where a decode step's time goes on the GPU.

Serves 8 requests at GPT-2-small widths (12 layers, random weights from
seed 0, 16-token pages; f32 pools of 1,024 pages by default) with
``ServingEngine``. Once all 8 are decoding, it traces ``--steps`` steps
with ``torch.profiler``. ``--kv-dtype bfloat16|int8`` stores the pools in
that dtype (decoding on its own kernel), ``--kv-budget-mb`` sizes them
from a byte budget instead, ``--prefix-cache`` turns the prefix cache on
and ``--prefill-chunk N`` prefills in N-token slices. It prints one JSON
line holding:

- the host wall time per step, without and under the profiler;
- the device busy time per step (the kernels' own time; one stream, so
  kernels do not overlap) and the idle share of the unprofiled step;
- the kernels launched per step;
- the kernels that take the most device time, with the paged-decode
  kernel's share.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python -m paddle_tpu_torch.tools.profile_decode [--steps 20]
        [--kv-dtype int8 --kv-budget-mb 1152] [--prefix-cache]
        [--prefill-chunk 64]
"""
import argparse
import json
import time

import numpy as np
import torch


def _self_device_us(evt) -> float:
    # the attribute was renamed from self_cuda_time_total
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--kv-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--kv-budget-mb", type=float, default=0.0,
                    help="size the pools from this byte budget (0: 1,024 "
                         "pages)")
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--prefill-chunk", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    from paddle_tpu_torch.inference.serving import (
        DecoderConfig, Request, ServingEngine, init_decoder_weights)

    cfg = DecoderConfig(vocab_size=50257, hidden=768, num_heads=12,
                        num_layers=12, max_seq_len=1024)
    eng = ServingEngine(cfg, init_decoder_weights(cfg, 0), num_pages=1024,
                        page_size=16, max_batch=8, token_budget=4096,
                        device="cuda", kv_dtype=args.kv_dtype,
                        kv_budget_mb=args.kv_budget_mb,
                        prefix_cache=args.prefix_cache,
                        prefill_chunk=args.prefill_chunk)
    rng = np.random.RandomState(0)
    for i, n in enumerate(rng.randint(32, 513, size=8)):
        eng.submit(Request(i, rng.randint(0, cfg.vocab_size,
                                          size=int(n)).tolist(),
                           max_new_tokens=2 * args.steps + 8))
    while eng.waiting or eng._prefill_job is not None:
        eng.step()               # admit (prefill) every request
    for _ in range(3):           # warm decode steps
        eng.step()
    if len(eng.running) != 8:
        raise SystemExit(f"profile_decode: {len(eng.running)} of 8 "
                         f"requests decoding")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):  # the same steps without the profiler
        eng.step()
    plain_wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()           # ends in a host read of the tokens
        wall = time.perf_counter() - t0
    # device-side entries only: an aten op's row repeats the device time
    # of the kernels it launched
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _self_device_us(e) > 0]
    busy_us = sum(_self_device_us(e) for e in kernels)
    if busy_us == 0:
        raise SystemExit("profile_decode: the trace holds no device time "
                         "(device time not measured)")
    steps = args.steps
    top = sorted(kernels, key=_self_device_us, reverse=True)[:12]
    paged_us = sum(_self_device_us(e) for e in kernels
                   if "paged_decode" in e.key)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "batch": 8,
        "steps": steps, "kv_dtype": args.kv_dtype,
        "pages": eng.core.kv_config.num_pages,
        "prefix_cache": args.prefix_cache,
        "prefill_chunk": args.prefill_chunk,
        "wall_ms_per_step": plain_wall / steps * 1e3,
        "wall_ms_per_step_profiled": wall / steps * 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / plain_wall,
        "kernels_per_step": sum(e.count for e in kernels) / steps,
        "paged_decode_ms_per_step": paged_us / steps / 1e3,
        "top_kernels": [{"name": e.key[:90],
                         "ms_per_step": _self_device_us(e) / steps / 1e3,
                         "calls_per_step": e.count / steps}
                        for e in top]}))


if __name__ == "__main__":
    main()
