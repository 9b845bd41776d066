"""How long a whole-prompt prefill takes on the GPU, per KV dtype.

Builds one ``ServingEngine`` per KV dtype at GPT-2-small widths (12
layers, random weights from seed 0, 16-token pages, f32 pools of 1,024
pages, bf16 / int8 pools from a 1,152 MiB budget) and prefills one
prompt of each ``--lengths`` entry (random tokens from seed 0) through
``_EngineCore.prefill``, the path a request's admission takes: the dense
forward and the K/V write of every layer.  Each prefill runs once
untimed, then ``--reps`` times between two device syncs, its pages freed
after each.  Prints one JSON line per (dtype, length): the lowest and
the median wall ms.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python -m paddle_tpu_torch.tools.time_prefill [--reps 5]
        [--kv-dtypes float32 int8] [--lengths 512 4000]
"""
import argparse
import json
import time

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kv-dtypes", nargs="+", default=["float32", "int8"],
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--lengths", nargs="+", type=int, default=[512, 4000])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_prefill: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    from paddle_tpu_torch.inference.serving import (
        DecoderConfig, Request, ServingEngine, init_decoder_weights)

    cfg = DecoderConfig(vocab_size=50257, hidden=768, num_heads=12,
                        num_layers=12, max_seq_len=1024)
    weights = init_decoder_weights(cfg, 0)
    rng = np.random.RandomState(0)
    prompts = {n: rng.randint(0, cfg.vocab_size, n).tolist()
               for n in args.lengths}
    for dtype in args.kv_dtypes:
        pool = dict(num_pages=1024) if dtype == "float32" else \
            dict(kv_budget_mb=1152)
        eng = ServingEngine(cfg, weights, page_size=16, max_batch=8,
                            token_budget=max(args.lengths) + 1,
                            device="cuda", kv_dtype=dtype, **pool)
        core, rid = eng.core, 0
        for n, prompt in prompts.items():
            times = []
            for rep in range(args.reps + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tok = core.prefill(Request(rid, prompt, 1))
                torch.cuda.synchronize()
                if tok is None:
                    raise SystemExit(f"time_prefill: {n} tokens do not fit "
                                     f"the {dtype} pool")
                if rep:
                    times.append((time.perf_counter() - t0) * 1e3)
                core.kv.free_sequence(rid)
                rid += 1
            print(json.dumps({"kv_dtype": dtype, "prompt": n,
                              "pages": core.kv_config.num_pages,
                              "min_ms": min(times),
                              "median_ms": float(np.median(times))}),
                  flush=True)
        del eng, core
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
