"""Every variant of kernel 9, checked and timed: the bf16 / fp16
tensor-core kernel, or with ``--dtype float32`` the f32 SIMT kernel.

For each shape and each variant of ``csrc/matmul_bias_act_tc.cu`` that
takes it (the TMA variants need K and N multiples of 8; the cp.async one
takes all), in bf16 and fp16, with an f32 bias and the shape's act: the
output against the plain version (within one rounding of the product
plus the f32 accumulators' own difference, 2^-18 |x| @ |w|, times the
act's steepest slope; the accumulators sum the K products in another
order than cuBLAS, which can move a product that nearly cancels by more
than a rounding step of its small value), whether a second call is
bit-equal to the first, then the time per call by CUDA-graph replay over
enough input sets to keep the 50 MB L2 cold, beside ``torch.addmm`` in
the same dtype plus the act.  With ``--dtype float32`` the variants are
those of ``csrc/matmul_bias_act.cu`` (the 16-byte w copies need N % 4 ==
0), the data f32 and the tolerance kernel 9's (rtol 2e-5, atol 2e-4, f32
sums in another order).  It prints one JSON line per (dtype, shape,
variant) and one ``best`` line per (dtype, shape); the variant that
``tc_variant`` (``f32_variant``) picks is marked.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python -m paddle_tpu_torch.tools.sweep_matmul_tc [--dtype bfloat16]
        [--shapes lenet-fc1,ffn-in]
"""
import argparse
import json
import subprocess

import torch

# (name, M, K, N, act): the static paths' fc layers and BERT-base's FFN-in
SHAPES = (("lenet-fc1", 256, 400, 120, "relu"),
          ("lenet-fc2", 256, 120, 84, "relu"),
          ("word2vec", 256, 128, 256, "sigmoid"),
          ("ragged", 1001, 517, 263, "relu"),
          ("tiles", 4096, 1024, 1024, "relu"),
          ("ffn-in", 22528, 768, 3072, "gelu"))
COLD_BYTES = 64 << 20
STEP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
ACC = 2.0 ** -18
# the f32 kernel vs its plain version: JAX's own kernel test's tolerance
F32_RTOL, F32_ATOL = 2e-5, 2e-4


def time_ms(fn, sets, replays):
    """Mean device ms per call, captured in a CUDA graph over the sets."""
    for args in sets:
        fn(*args)
    torch.cuda.synchronize()
    per_graph = max(len(sets), 4)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(per_graph):
            fn(*sets[i % len(sets)])
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="both",
                    choices=["both", "bfloat16", "float16", "float32"])
    ap.add_argument("--shapes", default=",".join(s[0] for s in SHAPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_matmul_tc: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False

    from paddle_tpu_torch.ops import matmul_epilogue as me
    from paddle_tpu_torch.ops.bn_act import apply_act

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)
    names = args.shapes.split(",")
    dtypes = (("bfloat16", "float16") if args.dtype == "both"
              else (args.dtype,))
    gen = torch.Generator(device="cuda").manual_seed(7)
    for amp_dtype in dtypes:
        dt = getattr(torch, amp_dtype)
        f32 = amp_dtype == "float32"
        kernel = {"bfloat16": me.matmul_bias_act_bf16,
                  "float16": me.matmul_bias_act_fp16,
                  "float32": me.matmul_bias_act_f32}[amp_dtype]
        for name, m, k, n, act in SHAPES:
            if name not in names:
                continue
            nbytes = dt.itemsize * (m * k + k * n) + 4 * (n + m * n)
            count = max(2, min(64, -(-COLD_BYTES // nbytes)))
            sets = [(torch.randn(m, k, device="cuda", generator=gen).to(dt),
                     (torch.randn(k, n, device="cuda", generator=gen)
                      / k ** 0.5).to(dt),
                     torch.randn(n, device="cuda", generator=gen))
                    for _ in range(count)]
            x, w, b = sets[0]
            want = me.matmul_bias_act_reference(x, w, b, act)
            if f32:
                bound = F32_ATOL + F32_RTOL * want.abs()
            else:
                prod = (x.float() @ w.float()).abs()
                bound = (1.13 * (STEP[amp_dtype] * prod + ACC
                                 * (x.float().abs() @ w.float().abs()))
                         + 1e-6 * want.abs() + 1e-7)
                del prod
            replays = 3 if m * n * k > 1e9 else 10
            picked = me.f32_variant(m, n, k) if f32 else me.tc_variant(m, n, k)
            rows = []
            for variant in (me.F32_VARIANTS if f32 else me.TC_VARIANTS):
                if f32 and variant.endswith("cp16") and n % 4:
                    continue
                if (not f32 and variant != "cp.async 64x64"
                        and (k % 8 or n % 8)):
                    continue

                def run(x, w, b, variant=variant):
                    return kernel(x, w, b, act, variant)

                got = run(x, w, b)
                torch.cuda.synchronize()
                ok = bool(torch.isfinite(got).all()) and bool(
                    ((got - want).abs() <= bound).all())
                twice = bool(torch.equal(got, run(x, w, b)))
                row = {"dtype": amp_dtype, "shape": name, "M": m, "K": k,
                       "N": n, "act": act, "variant": variant,
                       "picked": variant == picked, "ok": ok,
                       "repeatable": twice,
                       "max_abs_err": float((got - want).abs().max()),
                       "ms": time_ms(run, sets, replays)}
                row["tflops"] = 2 * m * n * k / row["ms"] / 1e9
                rows.append(row)
                print("sweep " + json.dumps(row), flush=True)
                del got
            lib_ms = time_ms(lambda x, w, b: apply_act(
                torch.addmm(b.to(dt), x, w), act), sets, replays)
            best = min(rows, key=lambda r: r["ms"])
            print("best " + json.dumps({
                "dtype": amp_dtype, "shape": name, "variant": best["variant"],
                "ms": best["ms"], "picked": picked,
                "picked_ms": next(r["ms"] for r in rows
                                  if r["variant"] == picked),
                "library_ms": lib_ms}), flush=True)
            del sets, x, w, b, want, bound
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
