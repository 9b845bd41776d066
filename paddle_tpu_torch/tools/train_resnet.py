"""ResNet static-graph training on the port: the counterpart of
``examples/train_resnet_static.py``.

    python -m paddle_tpu_torch.tools.train_resnet [--depth 50] [--batch 128]
        [--image 224] [--classes 1000] [--steps 100] [--warmup 2] [--lr 0.1]
        [--log-every 10] [--tiny] [--device cuda] [--profile N]

The example's flags and recipe: ``fluid.layers.data`` -> ``build_resnet``
-> ``MomentumOptimizer(lr, 0.9).minimize(loss)`` -> ``Executor.run`` of
the startup program, then of the main program with ``fetch_list=[loss,
acc1]``.  Weights come from the startup program (program seed 1), the
batch from numpy seed 0; the batch is made once and repeated, so the
loss falls at ``--lr 0.01``.  At the example's 0.1 the momentum
overshoots on the repeated batch: the loss falls for two steps, then
climbs and swings back, differently from run to run.  ``--warmup`` steps run before the timed ``--steps`` (the
first builds the plan and initializes cuDNN).  The run is float32:
``--no-amp`` is implied, ``--amp`` raises (AMP is not ported), and TF32
is turned off for convolutions and matrix products on the card.
``--tiny`` is ResNet-18 at batch 4, 32x32, 10 classes, 3 steps.  On the
card the fusion flag is ``auto``: every
conv -> BN (-> add) -> relu chain runs as ``fused_conv_bn_act``, whose
epilogue is the hand-written ``bn_act`` kernels.  ``--profile N`` runs N
more steps, traces N more with ``torch.profiler`` and prints one JSON
line: wall and device-busy ms per step, the idle share, the
convolutions', the two epilogue kernels' and the other kernels' ms per
step, and the kernels that take the most device time (a GPU is needed).
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
from ..models.resnet import build_resnet

__all__ = ["build_program", "make_batch", "train", "profile_steps", "main"]


def build_program(depth=50, image=224, classes=1000, lr=0.1, seed=1):
    """(main, startup, loss, acc1) of the example's training program,
    from a fresh name generator."""
    with unique_name.guard():
        main_prog, startup = fluid.Program(), fluid.Program()
        main_prog.random_seed = seed
        startup.random_seed = seed
        with fluid.program_guard(main_prog, startup):
            img = fluid.layers.data("img", [3, image, image])
            label = fluid.layers.data("label", [1], dtype="int64")
            loss, acc1, _, _ = build_resnet(img, label, depth=depth,
                                            class_num=classes)
            fluid.optimizer.MomentumOptimizer(lr, 0.9).minimize(loss)
    return main_prog, startup, loss, acc1


def make_batch(batch, image, classes, seed=0):
    """numpy ``(img, label)`` as the example draws them."""
    rng = np.random.RandomState(seed)
    img = rng.rand(batch, 3, image, image).astype(np.float32)
    label = rng.randint(0, classes, (batch, 1)).astype(np.int64)
    return img, label


def train(depth=50, batch=128, image=224, classes=1000, steps=100, lr=0.1,
          device="cuda", warmup=0, log_every=10) -> dict:
    """Train ``warmup + steps`` steps on one repeated batch; time the last
    ``steps`` (host wall time around steps that each end in a host read
    of the loss).  Returns the per-step losses and acc1, ms/step,
    images/s, and what a profiler needs (executor, program, feed,
    scope, fetches)."""
    dev = resolve_device(device)
    main_prog, startup, loss, acc1 = build_program(depth, image, classes, lr)
    exe = fluid.Executor(dev)
    scope = Scope()
    exe.run(startup, scope=scope)
    img, label = make_batch(batch, image, classes)
    feed = {"img": torch.from_numpy(img).to(dev),
            "label": torch.from_numpy(label).to(dev)}
    fetch = [loss, acc1]
    losses, accs = [], []
    t0 = time.perf_counter()
    for i in range(warmup + steps):
        if i == warmup:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        out = exe.run(main_prog, feed=feed, fetch_list=fetch, scope=scope)
        losses.append(float(out[0]))
        accs.append(float(out[1]))
        if log_every and (i % log_every == 0 or i == warmup + steps - 1):
            print(f"step {i}: loss {losses[-1]:.4f} acc1 {accs[-1]:.3f}",
                  flush=True)
    wall = time.perf_counter() - t0
    return {"losses": losses, "acc1": accs,
            "ms_per_step": wall / steps * 1e3,
            "images_per_s": batch * steps / wall, "executor": exe,
            "program": main_prog, "feed": feed, "scope": scope,
            "fetch": fetch}


def _self_device_us(evt) -> float:
    # the attribute was renamed from self_cuda_time_total
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def _is_conv(name: str) -> bool:
    n = name.lower()
    return any(k in n for k in ("conv", "wgrad", "dgrad", "fprop", "implicit",
                                "cudnn", "xmma", "sm90_", "sm80_"))


def profile_steps(run: dict, steps: int) -> dict:
    """Run ``steps`` warm steps of a :func:`train` result, then trace as
    many again with ``torch.profiler``: host wall ms per step without and
    under the profiler, device busy ms per step (one stream: kernels do
    not overlap), the idle share of the unprofiled step, and device ms per
    step of the convolutions (cuDNN's kernels, by name; the classifier's
    two small GEMMs fall in too), of the two epilogue kernels and of
    everything else."""
    exe, prog, feed, scope, fetch = (run["executor"], run["program"],
                                     run["feed"], run["scope"], run["fetch"])

    def step():
        exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    plain_wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _self_device_us(e) > 0]
    busy_us = sum(_self_device_us(e) for e in kernels)
    if busy_us == 0:
        raise SystemExit("train_resnet: the trace holds no device time "
                         "(device time not measured)")

    def ms(pred):
        return sum(_self_device_us(e) for e in kernels
                   if pred(e.key)) / steps / 1e3

    fwd_ms = ms(lambda k: "bn_act_fwd" in k)
    bwd_ms = ms(lambda k: "bn_act_bwd" in k)
    conv_ms = ms(lambda k: _is_conv(k) and "bn_act" not in k)
    top = sorted(kernels, key=_self_device_us, reverse=True)[:15]
    return {"device": torch.cuda.get_device_name(0), "steps": steps,
            "wall_ms_per_step": plain_wall / steps * 1e3,
            "wall_ms_per_step_profiled": wall / steps * 1e3,
            "device_busy_ms_per_step": busy_us / steps / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e6 / plain_wall,
            "kernels_per_step": sum(e.count for e in kernels) / steps,
            "conv_ms_per_step": conv_ms,
            "bn_act_apply_ms_per_step": fwd_ms,
            "bn_act_bwd_ms_per_step": bwd_ms,
            "other_ms_per_step": busy_us / steps / 1e3 - conv_ms - fwd_ms
            - bwd_ms,
            "top_kernels": [{"name": e.key[:90],
                             "ms_per_step": _self_device_us(e) / steps / 1e3,
                             "share": _self_device_us(e) / busy_us,
                             "calls_per_step": e.count / steps}
                            for e in top]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--log-every", type=int, default=10, metavar="K",
                    help="print the loss of every K-th step and the last")
    ap.add_argument("--no-amp", action="store_true",
                    help="accepted; the port always runs float32")
    ap.add_argument("--amp", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", type=int, default=0, metavar="N")
    args = ap.parse_args(argv)
    if args.amp:
        raise NotImplementedError("train_resnet --amp: AMP is not ported "
                                  "(ROADMAP.md)")
    if args.tiny:
        args.depth, args.batch, args.image = 18, 4, 32
        args.classes, args.steps = 10, 3
    if args.device != "cpu":
        # the f32 reference: no TF32 in convolutions or matrix products
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    run = train(args.depth, args.batch, args.image, args.classes, args.steps,
                args.lr, args.device, warmup=args.warmup,
                log_every=args.log_every)
    print(f"{args.steps} steps, {run['images_per_s']:.1f} img/s, "
          f"{run['ms_per_step']:.1f} ms/step", flush=True)
    if args.profile:
        print(json.dumps(profile_steps(run, args.profile)))


if __name__ == "__main__":
    main()
