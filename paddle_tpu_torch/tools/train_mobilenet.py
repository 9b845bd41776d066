"""MobileNetV3 static-graph training on the port, on the PaddleClas
recipe.

    python -m paddle_tpu_torch.tools.train_mobilenet [--scale large]
        [--batch 128] [--image 224] [--classes 1000] [--steps 100]
        [--warmup 2] [--lr 0.05] [--l2 2e-5] [--warmup-steps 2]
        [--steps-per-epoch 10] [--epochs 120]
        [--no-amp | --amp-dtype bfloat16|float16] [--log-every 10]
        [--tiny] [--device cuda] [--profile N]

The program: ``fluid.layers.data`` -> ``build_mobilenet_v3`` ->
``MomentumOptimizer(rate, 0.9, regularization=L2Decay(--l2))`` with
``rate = linear_lr_warmup(cosine_decay(--lr, --steps-per-epoch,
--epochs), --warmup-steps, 0, --lr)`` (the schedule runs in the
program: a step counter, ``floor`` and ``cos`` on the device), wrapped
in ``fluid.contrib.mixed_precision.decorate`` (bf16 AMP; ``--amp-dtype
float16``: fp16 with dynamic loss scaling) unless ``--no-amp`` is given
-> ``minimize(loss)`` -> ``Executor.run``.  Momentum 0.9, ``L2Decay(2e-5)``
and a linear warm-up into a cosine decay follow PaddleClas's
``MobileNetV3_large_x1_0`` training config (not in this repository).
The loop, the batch (numpy seed 0, made once and repeated), the timing
and ``--profile`` are ``train_resnet``'s (:func:`.train_resnet.run_steps`,
:func:`.train_resnet.profile_steps`).  The default ``--lr`` of 0.05 is a
rate at which the loss falls on the repeated batch: MobileNetV3-large in
f32 at batch 32, 64x64, 1,000 classes on the CPU goes 6.91 -> 2.86 over
12 steps, where at 0.4 it climbs from 5.17 at step 4 to 7.50 at step 6
(as ResNet-50 does at 0.1, ``train_resnet``); at the defaults on an H100
it goes 6.91 -> 6.23 over 10 steps (``chip_smoke.py``, ``PERF.md``).
``--tiny`` is MobileNetV3-small at batch 4, 32x32, 10 classes, 3 steps.
On the card the fusion and NHWC flags are ``auto``: every relu
bottleneck's expand and depthwise conv -> BN -> relu chain runs as
``fused_conv_bn_act`` (kernels 7-8) and each squeeze-excite block's first
fc as ``fused_matmul_bias_act`` (kernel 9); the AMP program runs
channels-last.
"""
from __future__ import annotations

import argparse
import json

from .. import fluid
from ..framework import unique_name
from ..models.mobilenet import build_mobilenet_v3
from .train_resnet import (AMP_DTYPES, decorate, print_loss_scaling,
                           profile_steps, run_steps, set_card_precision)

__all__ = ["RECIPE", "build_program", "train", "main"]

#: the recipe's defaults
RECIPE = dict(lr=0.05, l2=2e-5, warmup_steps=2, steps_per_epoch=10,
              epochs=120)


def build_program(scale="large", image=224, classes=1000, seed=1, amp=True,
                  amp_dtype="bfloat16", init_loss_scaling=None, **recipe):
    """(main, startup, loss, acc1) of the training program, from a fresh
    name generator; ``recipe`` overrides :data:`RECIPE`."""
    r = dict(RECIPE, **recipe)
    with unique_name.guard():
        main_prog, startup = fluid.Program(), fluid.Program()
        main_prog.random_seed = seed
        startup.random_seed = seed
        with fluid.program_guard(main_prog, startup):
            img = fluid.layers.data("img", [3, image, image])
            label = fluid.layers.data("label", [1], dtype="int64")
            loss, acc1, _ = build_mobilenet_v3(img, label, classes, scale)
            rate = fluid.layers.linear_lr_warmup(
                fluid.layers.cosine_decay(r["lr"], r["steps_per_epoch"],
                                          r["epochs"]),
                r["warmup_steps"], 0.0, r["lr"])
            opt = fluid.optimizer.MomentumOptimizer(
                rate, 0.9,
                regularization=fluid.regularizer.L2Decay(r["l2"]))
            if amp:
                opt = decorate(opt, amp_dtype, init_loss_scaling)
            opt.minimize(loss)
    return main_prog, startup, loss, acc1


def train(scale="large", batch=128, image=224, classes=1000, steps=100,
          device="cuda", warmup=0, log_every=10, amp=True,
          amp_dtype="bfloat16", **recipe) -> dict:
    """Train ``warmup + steps`` steps on one repeated batch
    (:func:`.train_resnet.run_steps`)."""
    main_prog, startup, loss, acc1 = build_program(
        scale, image, classes, amp=amp, amp_dtype=amp_dtype, **recipe)
    return run_steps(main_prog, startup, loss, acc1, batch, image, classes,
                     steps, device, warmup, log_every)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", choices=("small", "large"), default="large")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=2,
                    help="untimed steps before the timed ones")
    ap.add_argument("--lr", type=float, default=RECIPE["lr"])
    ap.add_argument("--l2", type=float, default=RECIPE["l2"])
    ap.add_argument("--warmup-steps", type=int,
                    default=RECIPE["warmup_steps"],
                    help="steps of the rate's linear warm-up")
    ap.add_argument("--steps-per-epoch", type=int,
                    default=RECIPE["steps_per_epoch"])
    ap.add_argument("--epochs", type=int, default=RECIPE["epochs"])
    ap.add_argument("--log-every", type=int, default=10, metavar="K")
    ap.add_argument("--no-amp", action="store_true",
                    help="train in float32 (default: bf16 AMP)")
    ap.add_argument("--amp-dtype", choices=AMP_DTYPES, default="bfloat16")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", type=int, default=0, metavar="N")
    args = ap.parse_args(argv)
    if args.tiny:
        args.scale, args.batch, args.image = "small", 4, 32
        args.classes, args.steps = 10, 3
    if args.device != "cpu":
        set_card_precision()
    run = train(args.scale, args.batch, args.image, args.classes, args.steps,
                args.device, warmup=args.warmup, log_every=args.log_every,
                amp=not args.no_amp, amp_dtype=args.amp_dtype, lr=args.lr,
                l2=args.l2, warmup_steps=args.warmup_steps,
                steps_per_epoch=args.steps_per_epoch, epochs=args.epochs)
    print(f"{args.steps} steps, {run['images_per_s']:.1f} img/s, "
          f"{run['ms_per_step']:.1f} ms/step", flush=True)
    if args.profile:
        print(json.dumps(profile_steps(run, args.profile)))
        print_loss_scaling(run)


if __name__ == "__main__":
    main()
