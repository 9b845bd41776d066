"""Static-graph training of the book models on the port: LeNet-5 and the
word2vec N-gram language model.

    python -m paddle_tpu_torch.tools.train_book --model lenet|word2vec
        [--batch B] [--steps 30] [--warmup 5] [--lr LR] [--amp]
        [--amp-dtype bfloat16|float16] [--log-every 10] [--tiny]
        [--device cuda] [--profile N]

The recipe is the JAX package's: ``fluid.layers.data`` -> the model's
builder -> an optimizer's ``minimize(loss)`` -> ``Executor.run`` of the
startup program, then of the main program on one batch made once and
repeated.

* ``lenet`` is ``bench.py:bench_lenet``'s configuration: batch 256 of
  1x28x28 images, ``MomentumOptimizer(0.01, 0.9)``, program seed 1, the
  batch from numpy seed 0; it fetches the loss and the accuracy.
* ``word2vec`` is the model's defaults (embedding 32, hidden 256, four
  context words) over a vocabulary of 2,048 ids, batch 256,
  ``SGDOptimizer(0.1)`` as ``tests/test_book_models.py`` trains it,
  program seed 1.  The repository holds no corpus, so the context and
  target ids are drawn from numpy seed 0.

``--tiny`` is batch 8 and 3 steps (word2vec: vocabulary 50, embedding
16, hidden 32, the JAX test's sizes).  The run is float32 with TF32 off
on the card; ``--amp`` wraps the optimizer in
``fluid.contrib.mixed_precision.decorate`` (bf16 AMP: the products and
convolutions in bf16, f32 master weights); ``--amp-dtype float16`` (which
implies ``--amp``) is ``decorate(use_fp16=True)``, fp16 with dynamic loss
scaling, whose logged steps also print the scale and the found-Inf flag.
On the card the fusion flag is ``auto``: every fc -> bias -> act chain
(LeNet's two relu layers, word2vec's sigmoid layer) runs as
``fused_matmul_bias_act``, whose epilogue is the hand-written kernel 9 of
the operands' dtype.
``--profile N`` runs N more steps op by op, traces N more with
``torch.profiler`` and prints one JSON line: wall and device-busy ms per
step, the idle share, kernel 9's, cuBLAS's GEMMs', cuDNN's convolutions'
and the other kernels' ms per step, and the kernels that take the most
device time, all with ``FLAGS_cuda_step_session=0``; under
``step_session`` the wall and busy ms per step and the idle share with
the compiled step off and on, in turns (a GPU is needed); in float16 one more line gives the steps that found an
Inf and the scale after each step of the run.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import fluid
from ..framework import unique_name
from ..framework.place import resolve_device
from ..framework.scope import Scope
from ..models.lenet import build_lenet
from ..models.word2vec import build_word2vec
from .train_resnet import (AMP_DTYPES, _is_conv, decorate,
                           loss_scaling_state, print_loss_scaling,
                           profile_steps, set_card_precision)

__all__ = ["DEFAULTS", "TINY", "build_program", "make_batch", "train",
           "BOOK_GROUPS", "main"]

#: per model: batch, learning rate, and word2vec's widths
DEFAULTS = {
    "lenet": {"batch": 256, "lr": 0.01},
    "word2vec": {"batch": 256, "lr": 0.1, "dict_size": 2048,
                 "embed_dim": 32, "hidden_size": 256},
}
#: ``--tiny``: the same programs at test sizes
TINY = {
    "lenet": {"batch": 8, "lr": 0.01},
    "word2vec": {"batch": 8, "lr": 0.1, "dict_size": 50, "embed_dim": 16,
                 "hidden_size": 32},
}
CONTEXT = 4


def _is_library_gemm(name: str) -> bool:
    """cuBLAS's GEMMs (``sm80_xmma_gemm_*``, ``*sgemm*``), not cuDNN's
    implicit-GEMM convolutions."""
    n = name.lower()
    return "gemm" in n and not any(w in n for w in ("fprop", "dgrad",
                                                    "wgrad", "implicit"))


#: the book models' kernel groups: report key -> test on the kernel's name
BOOK_GROUPS = {
    "matmul_bias_act_ms_per_step": lambda k: "matmul_bias_act" in k,
    "gemm_ms_per_step": _is_library_gemm,
    "conv_ms_per_step": lambda k: (_is_conv(k) and not _is_library_gemm(k)
                                   and "matmul_bias_act" not in k),
}


def build_program(model, cfg, seed=1, amp=False, amp_dtype="bfloat16"):
    """(main, startup, fetches) of ``model``'s training program, from a
    fresh name generator; ``fetches[0]`` is the loss (LeNet: then the
    accuracy).  ``amp`` wraps the optimizer in ``decorate`` in
    ``amp_dtype``."""
    with unique_name.guard():
        main_prog, startup = fluid.Program(), fluid.Program()
        main_prog.random_seed = seed
        startup.random_seed = seed
        with fluid.program_guard(main_prog, startup):
            if model == "lenet":
                img = fluid.layers.data("img", [1, 28, 28])
                label = fluid.layers.data("label", [1], dtype="int64")
                loss, acc, _ = build_lenet(img, label)
                fetches = [loss, acc]
                opt = fluid.optimizer.MomentumOptimizer(cfg["lr"], 0.9)
            else:
                words = [fluid.layers.data(f"w{i}", [1], dtype="int64")
                         for i in range(CONTEXT)]
                target = fluid.layers.data("target", [1], dtype="int64")
                loss, _ = build_word2vec(words, target, cfg["dict_size"],
                                         cfg["embed_dim"], cfg["hidden_size"])
                fetches = [loss]
                opt = fluid.optimizer.SGDOptimizer(cfg["lr"])
            if amp:
                opt = decorate(opt, amp_dtype)
            opt.minimize(loss)
    return main_prog, startup, fetches


def make_batch(model, cfg, seed=0):
    """One numpy feed: LeNet's images and labels as ``bench_lenet`` draws
    them, or word2vec's four context ids and target id per row."""
    rng = np.random.RandomState(seed)
    batch = cfg["batch"]
    if model == "lenet":
        return {"img": rng.rand(batch, 1, 28, 28).astype(np.float32),
                "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}
    ids = rng.randint(0, cfg["dict_size"], (batch, CONTEXT + 1))
    feed = {f"w{i}": ids[:, i:i + 1].astype(np.int64) for i in range(CONTEXT)}
    feed["target"] = ids[:, CONTEXT:].astype(np.int64)
    return feed


def train(model="lenet", cfg=None, steps=30, device="cuda", warmup=0,
          log_every=10, amp=False, amp_dtype="bfloat16") -> dict:
    """Train ``warmup + steps`` steps on one repeated batch; time the last
    ``steps`` (host wall time around steps that each end in a host read
    of the loss).  Returns the per-step losses (and LeNet's accuracy),
    ms/step, examples/s, and what a profiler needs (executor, program,
    feed, scope, fetches); under dynamic loss scaling also each step's
    found-Inf flag and the scale after it (``found_inf``,
    ``loss_scaling``)."""
    cfg = dict(DEFAULTS[model] if cfg is None else cfg)
    dev = resolve_device(device)
    main_prog, startup, fetch = build_program(model, cfg, amp=amp,
                                              amp_dtype=amp_dtype)
    exe = fluid.Executor(dev)
    scope = Scope()
    exe.run(startup, scope=scope)
    feed = {k: torch.from_numpy(v).to(dev)
            for k, v in make_batch(model, cfg).items()}
    # under loss scaling the scale and the found-Inf flag are fetched too
    # (in every step, so a profile of the run reuses the same plan)
    scaling = loss_scaling_state(main_prog)
    n_model = len(fetch)
    fetch = fetch + list(scaling or ())
    losses, accs, scales, found = [], [], [], []
    t0 = time.perf_counter()
    for i in range(warmup + steps):
        if i == warmup:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        out = exe.run(main_prog, feed=feed, fetch_list=fetch, scope=scope)
        losses.append(float(out[0]))
        if n_model > 1:
            accs.append(float(out[1]))
        line = (f"step {i}: loss {losses[-1]:.4f}"
                + (f" acc {accs[-1]:.3f}" if accs else ""))
        if scaling:
            scales.append(float(out[n_model][0]))
            found.append(bool(out[n_model + 1][0]))
            line += f" scale {scales[-1]:g} found_inf {found[-1]}"
        if log_every and (i % log_every == 0 or i == warmup + steps - 1):
            print(line, flush=True)
    wall = time.perf_counter() - t0
    run = {"losses": losses, "acc": accs,
           "ms_per_step": wall / steps * 1e3,
           "examples_per_s": cfg["batch"] * steps / wall, "executor": exe,
           "program": main_prog, "feed": feed, "scope": scope,
           "fetch": fetch}
    if scaling:
        run.update(loss_scaling=scales, found_inf=found)
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(DEFAULTS), default="lenet")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--log-every", type=int, default=10, metavar="K",
                    help="print the loss of every K-th step and the last")
    ap.add_argument("--amp", action="store_true",
                    help="bf16 AMP (fluid.contrib.mixed_precision.decorate)")
    ap.add_argument("--amp-dtype", choices=AMP_DTYPES, default=None,
                    help="the AMP dtype (implies --amp); float16 is "
                         "decorate(use_fp16=True) with dynamic loss scaling")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", type=int, default=0, metavar="N")
    args = ap.parse_args(argv)
    cfg = dict((TINY if args.tiny else DEFAULTS)[args.model])
    if args.tiny:
        args.steps, args.warmup = 3, 0
    if args.batch is not None:
        cfg["batch"] = args.batch
    if args.lr is not None:
        cfg["lr"] = args.lr
    amp = args.amp or args.amp_dtype is not None
    amp_dtype = args.amp_dtype or "bfloat16"
    if args.device != "cpu":
        set_card_precision()
    run = train(args.model, cfg, args.steps, args.device, warmup=args.warmup,
                log_every=args.log_every, amp=amp, amp_dtype=amp_dtype)
    tag = {"bfloat16": " (AMP bf16)", "float16": " (AMP fp16)"}[amp_dtype]
    print(f"{args.model}{tag if amp else ''}: "
          f"{args.steps} steps, "
          f"{run['examples_per_s']:.1f} examples/s, "
          f"{run['ms_per_step']:.2f} ms/step", flush=True)
    if args.profile:
        print(json.dumps(profile_steps(run, args.profile, BOOK_GROUPS)))
        print_loss_scaling(run)


if __name__ == "__main__":
    main()
