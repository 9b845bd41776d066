"""BERT/ERNIE-base dygraph pretraining on the port: the counterpart of
``examples/train_bert_dygraph.py``.

    python -m paddle_tpu_torch.tools.train_bert [--batch 44] [--seq 512]
        [--steps 100] [--lr 1e-4] [--no-amp | --amp-level O1|O2] [--tiny]
        [--pad] [--device cuda] [--profile N]

The example's flags, and its default: AMP O1 in bfloat16
(``jit_train_step(amp=True)``: the matmuls and the attention in bf16,
parameters and optimizer state f32).  ``--amp-level O2`` makes the
parameters resident in bf16 with f32 master weights in the optimizer;
``--no-amp`` runs float32.  ``BertForPretraining(BertConfig())``
(BERT-base) trains on random ids and labels from numpy seed 0 with
``AdamOptimizer`` through ``jit_train_step``; the attention runs in the
hand-written flash kernels on the card, bf16 ones under AMP.  ``--tiny``
is a 2-layer model of hidden 128 and 4 heads (head width 32, the
kernels' smallest) at batch 2, sequence 32, 3 steps.
``--pad`` adds an attention mask whose rows keep between half and all of
their tokens.  ``--profile N`` then runs N more steps, traces N more with
``torch.profiler`` and prints one JSON line: wall and device-busy ms per
step, the device's idle share, the flash kernels' and the GEMMs' ms per
step, and the kernels that take the most device time (a GPU is needed).
"""
from __future__ import annotations

import argparse
import json
import time
import numpy as np
import torch

from ..dygraph import jit_train_step, to_tensor
from ..framework.place import resolve_device
from ..models.bert import BertConfig, BertForPretraining
from ..optimizer import AdamOptimizer

__all__ = ["tiny_config", "make_batch", "train", "profile_steps", "main"]


def tiny_config() -> BertConfig:
    return BertConfig(vocab_size=128, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=256,
                      max_position_embeddings=64)


def make_batch(cfg: BertConfig, batch: int, seq: int, seed: int = 0,
               pad: bool = False):
    """numpy ``(ids, labels, attention_mask or None)``: random ids and
    labels; with ``pad`` each row keeps its first n tokens, n drawn in
    [seq / 2, seq]."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
    labels = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
    mask = None
    if pad:
        keep = rng.randint(seq // 2, seq + 1, size=batch)
        mask = (np.arange(seq)[None, :] < keep[:, None]).astype(np.float32)
    return ids, labels, mask


def _loss_fn(model, ids, labels, mask=None):
    return model(ids, labels, attention_mask=mask)


def train(cfg: BertConfig, batch: int = 44, seq: int = 512, steps: int = 100,
          lr: float = 1e-4, device="cuda", pad: bool = False,
          warmup: int = 0, log_every: int = 20, amp: bool = True,
          amp_level: str = "O1") -> dict:
    """Train ``warmup + steps`` steps on one repeated batch (weights and
    batch from seed 0); time the last ``steps``.  ``amp`` / ``amp_level``
    go to ``jit_train_step`` (bf16 AMP O1 by default, as the example).
    Returns the per-step losses, ms/step and tokens/s (host wall time
    around steps that end in a device sync), the model, the optimizer,
    the step function and its inputs."""
    dev = resolve_device(device)
    model = BertForPretraining(cfg, device=dev, seed=0)
    opt = AdamOptimizer(lr, parameter_list=model.parameters())
    step = jit_train_step(model, opt, _loss_fn, amp=amp,
                          amp_level=amp_level)
    inputs = [to_tensor(x, dev) for x in make_batch(cfg, batch, seq, 0, pad)
              if x is not None]
    losses = []
    for i in range(warmup + steps):
        if i == warmup:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        loss = float(step(*inputs))     # a host read: one sync per step
        losses.append(loss)
        if log_every and (i % log_every == 0 or i == warmup + steps - 1):
            print(f"step {i}: loss {loss:.4f}", flush=True)
    wall = time.perf_counter() - t0
    return {"losses": losses, "ms_per_step": wall / steps * 1e3,
            "tokens_per_s": batch * seq * steps / wall, "model": model,
            "optimizer": opt, "step": step, "inputs": inputs}


def _self_device_us(evt) -> float:
    # the attribute was renamed from self_cuda_time_total
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def profile_steps(step, inputs, steps: int) -> dict:
    """Run ``steps`` warm train steps, then trace as many again with
    ``torch.profiler``: host wall ms per step without and under the
    profiler, device busy ms per step (one stream: the kernels do not
    overlap), the idle share of the unprofiled step, kernels per step and
    the top kernels."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        float(step(*inputs))       # each step ends in a host read
    plain_wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            float(step(*inputs))
        wall = time.perf_counter() - t0
    # device-side entries only: an aten op's row repeats the device time
    # of the kernels it launched
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _self_device_us(e) > 0]
    busy_us = sum(_self_device_us(e) for e in kernels)
    if busy_us == 0:
        raise SystemExit("train_bert: the trace holds no device time "
                         "(device time not measured)")
    top = sorted(kernels, key=_self_device_us, reverse=True)[:15]
    flash_us = sum(_self_device_us(e) for e in kernels if "flash" in e.key)
    # cuBLAS's GEMMs: "gemm" in the name, or its Hopper "nvjet" family
    gemm_us = sum(_self_device_us(e) for e in kernels
                  if "gemm" in e.key.lower() or "nvjet" in e.key)
    return {"device": torch.cuda.get_device_name(0), "steps": steps,
            "wall_ms_per_step": plain_wall / steps * 1e3,
            "wall_ms_per_step_profiled": wall / steps * 1e3,
            "device_busy_ms_per_step": busy_us / steps / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / plain_wall,
            "kernels_per_step": sum(e.count for e in kernels) / steps,
            "flash_ms_per_step": flash_us / steps / 1e3,
            "gemm_ms_per_step": gemm_us / steps / 1e3,
            "top_kernels": [{"name": e.key[:90],
                             "ms_per_step": _self_device_us(e) / steps / 1e3,
                             "share": _self_device_us(e) / busy_us,
                             "calls_per_step": e.count / steps}
                            for e in top]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=44)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--no-amp", action="store_true",
                    help="train in float32 (default: bf16 AMP)")
    ap.add_argument("--amp-level", choices=("O1", "O2"), default="O1")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--pad", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", type=int, default=0, metavar="N")
    args = ap.parse_args(argv)
    if args.tiny:
        cfg = tiny_config()
        args.batch, args.seq, args.steps = 2, 32, 3
    else:
        cfg = BertConfig()
    if args.device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False   # full f32
        # bf16 GEMMs accumulate in f32 throughout, as the JAX package's
        # (cuBLAS may otherwise reduce split-K partial sums in bf16)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    run = train(cfg, args.batch, args.seq, args.steps, args.lr, args.device,
                pad=args.pad, amp=not args.no_amp, amp_level=args.amp_level)
    mode = "f32" if args.no_amp else f"AMP {args.amp_level} bf16"
    print(f"{args.steps} steps ({mode}), {run['tokens_per_s']:.0f} tok/s, "
          f"{run['ms_per_step']:.1f} ms/step", flush=True)
    if args.profile:
        print(json.dumps(profile_steps(run["step"], run["inputs"],
                                       args.profile)))


if __name__ == "__main__":
    main()
