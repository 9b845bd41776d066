"""ResNet static-graph training on the port: the counterpart of
``examples/train_resnet_static.py``.

    python -m paddle_tpu_torch.tools.train_resnet [--depth 50] [--batch 128]
        [--image 224] [--classes 1000] [--steps 100] [--warmup 2] [--lr 0.1]
        [--no-amp | --amp-dtype bfloat16|float16] [--log-every 10] [--tiny]
        [--device cuda] [--profile N]

The example's flags and recipe: ``fluid.layers.data`` -> ``build_resnet``
-> ``MomentumOptimizer(lr, 0.9)``, wrapped in
``fluid.contrib.mixed_precision.decorate`` (bf16 AMP, no loss scaling;
``--amp-dtype float16``: ``decorate(use_fp16=True)``, fp16 AMP with
decorate's dynamic loss scaling) unless ``--no-amp`` is given ->
``minimize(loss)`` -> ``Executor.run`` of
the startup program, then of the main program with ``fetch_list=[loss,
acc1]``.  Weights come from the startup program (program seed 1), the
batch from numpy seed 0; the batch is made once and repeated, so the
loss falls at ``--lr 0.01``.  At the example's 0.1 the momentum
overshoots on the repeated batch: the loss falls for two steps, then
climbs and swings back, differently from run to run.  ``--warmup`` steps run before the timed ``--steps`` (the
first builds the plan and initializes cuDNN).  AMP is the default, as
in the example (``--amp`` is accepted and changes nothing); on the card
cuBLAS's reduced-precision bf16 and fp16 reductions are turned off.  In
float16 each logged step also prints the loss scale after the step and
whether the step found an Inf or a NaN (and so skipped its update).  With
``--no-amp`` the run is float32, with TF32 off for convolutions and
matrix products on the card.  ``--tiny`` is ResNet-18 at batch 4,
32x32, 10 classes, 3 steps.  On the card the fusion and NHWC flags are
``auto``: the AMP program (bf16 or fp16) runs channels-last
(``layout_transform_pass``;
the f32 one stays NCHW, where cuDNN's f32 convolutions are faster) and
every conv -> BN (-> add) -> relu chain runs as ``fused_conv_bn_act``,
whose epilogue is the hand-written ``bn_act`` kernels of the activations'
dtype.  ``--profile N`` runs N more steps op by op, traces N more with
``torch.profiler`` and prints one JSON line: wall and device-busy ms per
step, the idle share, the device ms per step of the convolutions, the
two epilogue kernels, the BN reductions, the copy kernels (casts and
layout transposes) and everything else, each program op type's span on
the device timeline per step, and the kernels that take the most device
time, all with ``FLAGS_cuda_step_session=0`` (the per-op ranges need the
eager path); under ``step_session`` the wall and busy ms per step and
the idle share with the compiled step off and on, in turns (a GPU is
needed); in float16 one more line gives the steps that
found an Inf and the scale after each step of the run.
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
from ..utils.flags import get_flag, set_flags
from .step_timing import self_device_us as _self_device_us
from .step_timing import session_turns

__all__ = ["AMP_DTYPES", "build_program", "make_batch", "train",
           "run_steps", "loss_scaling_state", "print_loss_scaling",
           "profile_steps", "set_card_precision", "main"]

#: ``--amp-dtype`` choices; float16 is ``decorate(use_fp16=True)``
AMP_DTYPES = ("bfloat16", "float16")


def decorate(opt, amp_dtype="bfloat16", init_loss_scaling=None):
    """``opt`` under ``fluid.contrib.mixed_precision.decorate`` in
    ``amp_dtype``, with decorate's defaults (float16: dynamic loss
    scaling from 2^15, or from ``init_loss_scaling``)."""
    if amp_dtype not in AMP_DTYPES:
        raise ValueError(f"amp_dtype {amp_dtype!r} not in {AMP_DTYPES}")
    kw = {} if init_loss_scaling is None else {
        "init_loss_scaling": init_loss_scaling}
    return fluid.contrib.mixed_precision.decorate(
        opt, use_fp16=amp_dtype == "float16", **kw)


def build_program(depth=50, image=224, classes=1000, lr=0.1, seed=1,
                  amp=True, amp_dtype="bfloat16", init_loss_scaling=None):
    """(main, startup, loss, acc1) of the example's training program,
    from a fresh name generator; ``amp`` wraps the optimizer in
    ``decorate`` in ``amp_dtype`` (:func:`decorate`)."""
    with unique_name.guard():
        main_prog, startup = fluid.Program(), fluid.Program()
        main_prog.random_seed = seed
        startup.random_seed = seed
        with fluid.program_guard(main_prog, startup):
            img = fluid.layers.data("img", [3, image, image])
            label = fluid.layers.data("label", [1], dtype="int64")
            loss, acc1, _, _ = build_resnet(img, label, depth=depth,
                                            class_num=classes)
            opt = fluid.optimizer.MomentumOptimizer(lr, 0.9)
            if amp:
                opt = decorate(opt, amp_dtype, init_loss_scaling)
            opt.minimize(loss)
    return main_prog, startup, loss, acc1


def loss_scaling_state(program):
    """(loss-scale var name, found-Inf var name) of a program under
    ``decorate(use_fp16=True)`` with dynamic loss scaling, read from its
    ``update_loss_scaling`` op; None for any other program."""
    for op_ in program.global_block().ops:
        if op_.type == "update_loss_scaling":
            return (op_.output("LossScalingOut")[0],
                    op_.input("FoundInfinite")[0])
    return None


def make_batch(batch, image, classes, seed=0):
    """numpy ``(img, label)`` as the example draws them."""
    rng = np.random.RandomState(seed)
    img = rng.rand(batch, 3, image, image).astype(np.float32)
    label = rng.randint(0, classes, (batch, 1)).astype(np.int64)
    return img, label


def train(depth=50, batch=128, image=224, classes=1000, steps=100, lr=0.1,
          device="cuda", warmup=0, log_every=10, amp=True,
          amp_dtype="bfloat16") -> dict:
    """Train ``warmup + steps`` steps of the example's program on one
    repeated batch (:func:`run_steps`)."""
    main_prog, startup, loss, acc1 = build_program(
        depth, image, classes, lr, amp=amp, amp_dtype=amp_dtype)
    return run_steps(main_prog, startup, loss, acc1, batch, image, classes,
                     steps, device, warmup, log_every)


def run_steps(main_prog, startup, loss, acc1, batch, image, classes, steps,
              device="cuda", warmup=0, log_every=10) -> dict:
    """Run the startup program, then ``warmup + steps`` steps of an image
    classifier's train program (feeds ``img`` and ``label``) on one
    repeated batch; time the last ``steps`` (host wall time around steps
    that each end in a host read of the loss).  Returns the per-step
    losses and acc1, ms/step, images/s, and what a profiler needs
    (executor, program, feed, scope, fetches); under dynamic loss scaling
    also each step's found-Inf flag and the scale after it
    (``found_inf``, ``loss_scaling``), fetched with the loss."""
    dev = resolve_device(device)
    exe = fluid.Executor(dev)
    scope = Scope()
    exe.run(startup, scope=scope)
    img, label = make_batch(batch, image, classes)
    feed = {"img": torch.from_numpy(img).to(dev),
            "label": torch.from_numpy(label).to(dev)}
    # under loss scaling the scale and the found-Inf flag are fetched too
    # (in every step, so a profile of the run reuses the same plan)
    scaling = loss_scaling_state(main_prog)
    fetch = [loss, acc1] + list(scaling or ())
    losses, accs, scales, found = [], [], [], []
    t0 = time.perf_counter()
    for i in range(warmup + steps):
        if i == warmup:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        out = exe.run(main_prog, feed=feed, fetch_list=fetch, scope=scope)
        losses.append(float(out[0]))
        accs.append(float(out[1]))
        line = f"step {i}: loss {losses[-1]:.4f} acc1 {accs[-1]:.3f}"
        if scaling:
            scales.append(float(out[2][0]))
            found.append(bool(out[3][0]))
            line += f" scale {scales[-1]:g} found_inf {found[-1]}"
        if log_every and (i % log_every == 0 or i == warmup + steps - 1):
            print(line, flush=True)
    wall = time.perf_counter() - t0
    run = {"losses": losses, "acc1": accs,
           "ms_per_step": wall / steps * 1e3,
           "images_per_s": batch * steps / wall, "executor": exe,
           "program": main_prog, "feed": feed, "scope": scope,
           "fetch": fetch}
    if scaling:
        run.update(loss_scaling=scales, found_inf=found)
    return run


def _is_conv(name: str) -> bool:
    n = name.lower()
    return any(k in n for k in ("conv", "wgrad", "dgrad", "fprop", "implicit",
                                "cudnn", "xmma", "sm90_", "sm80_"))


def _is_copy(name: str) -> bool:
    """PyTorch's copy kernels: dtype casts and the layout transposes'
    materializing copies."""
    return "copy" in name.lower()


#: ResNet's kernel groups: report key -> test on the kernel's name (the
#: groups are disjoint; everything else is ``other_ms_per_step``)
RESNET_GROUPS = {
    "conv_ms_per_step": lambda k: (_is_conv(k) and "bn_act" not in k
                                   and not _is_copy(k)),
    "bn_act_apply_ms_per_step": lambda k: "bn_act_fwd" in k,
    "bn_act_bwd_ms_per_step": lambda k: "bn_act_bwd" in k,
    "bn_reduce_ms_per_step": lambda k: "reduce_kernel" in k,
    "copy_ms_per_step": _is_copy,
}


def profile_steps(run: dict, steps: int, groups=None,
                  between=None, turns=("0", "1", "1", "0")) -> dict:
    """Run ``steps`` warm steps of a :func:`train` result op by op
    (``FLAGS_cuda_step_session=0``: the per-op ranges need the eager
    path), then trace as many again with ``torch.profiler``: host wall ms
    per step without and under the profiler, device busy ms per step (one
    stream: kernels do not overlap), the idle share of the unprofiled
    step, device ms per step of each of ``groups``' kernels (default: the
    convolutions, cuDNN's kernels by name, the classifier's two small
    GEMMs falling in too, and the two epilogue kernels) and of everything
    else, and per program op type its kernels' device ms and their span
    on the timeline (gaps included).  Then ``step_session``: wall and busy
    ms per step and the idle
    share with the compiled step off and on, in ``turns``
    (:func:`~.step_timing.session_turns`; ``between`` runs after each
    turn and may put a new executor in ``run["executor"]``)."""
    groups = RESNET_GROUPS if groups is None else groups
    prog, feed, scope, fetch = (run["program"], run["feed"], run["scope"],
                                run["fetch"])

    def step():
        run["executor"].run(prog, feed=feed, fetch_list=fetch, scope=scope)

    prev = get_flag("FLAGS_cuda_step_session")
    set_flags({"FLAGS_cuda_step_session": "0"})
    try:
        report = _profile_eager(run["executor"], step, steps, groups)
    finally:
        set_flags({"FLAGS_cuda_step_session": prev})
    report["step_session"] = session_turns(step, steps, turns,
                                           between=between)
    return report


def _profile_eager(exe, step, steps: int, groups) -> dict:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    plain_wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    exe.trace_ops = True
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            wall = time.perf_counter() - t0
    finally:
        exe.trace_ops = False
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # the op ranges appear on the device timeline too, as annotations
    # spanning their kernels: they are not kernels
    kernels = [e for e in events if e.device_type == cuda
               and _self_device_us(e) > 0 and not e.key.startswith("op:")]
    by_op = {e.key[3:]: _self_device_us(e) / steps / 1e3 for e in events
             if e.device_type == cuda and e.key.startswith("op:")}
    # per program op type: the device time of the kernels its ops launch
    # (the host-side range's children), without the gaps a span holds
    op_kernels = {e.key[3:]: _device_us(e) / steps / 1e3 for e in events
                  if e.device_type != cuda and e.key.startswith("op:")}
    busy_us = sum(_self_device_us(e) for e in kernels)
    if busy_us == 0:
        raise SystemExit("profile_steps: the trace holds no device time "
                         "(device time not measured)")
    busy_ms = busy_us / steps / 1e3
    by_group = {key: sum(_self_device_us(e) for e in kernels
                         if pred(e.key)) / steps / 1e3
                for key, pred in groups.items()}
    top = sorted(kernels, key=_self_device_us, reverse=True)[:15]
    return {"device": torch.cuda.get_device_name(0), "steps": steps,
            "wall_ms_per_step": plain_wall / steps * 1e3,
            "wall_ms_per_step_profiled": wall / steps * 1e3,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_us / 1e6 / plain_wall,
            "kernels_per_step": sum(e.count for e in kernels) / steps,
            **by_group,
            "other_ms_per_step": busy_ms - sum(by_group.values()),
            # per program op type: the device-timeline span of its
            # kernels (gaps between them included), summed over its ops
            "op_type_span_ms_per_step": {
                k: v for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])
                if v > 0} or "not measured",
            "op_type_device_ms_per_step": {
                k: v for k, v in sorted(op_kernels.items(),
                                        key=lambda kv: -kv[1])
                if v > 0} or "not measured",
            "top_kernels": [{"name": e.key[:90],
                             "ms_per_step": _self_device_us(e) / steps / 1e3,
                             "share": _self_device_us(e) / busy_us,
                             "calls_per_step": e.count / steps}
                            for e in top]}


def _device_us(evt) -> float:
    """A profiler event's device time in us, its children's included
    (the attribute was renamed from ``cuda_time_total``)."""
    t = getattr(evt, "device_time_total", None)
    return float(t if t is not None else evt.cuda_time_total)


def set_card_precision():
    """The reference precision on the card: no TF32 in f32 convolutions
    and matrix products (PyTorch allows it in cuDNN by default), and f32
    accumulation throughout cuBLAS's bf16 and fp16 products."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


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
                    help="train in float32 (default: bf16 AMP, as the "
                         "example)")
    ap.add_argument("--amp-dtype", choices=AMP_DTYPES, default="bfloat16",
                    help="the AMP dtype; float16 is decorate(use_fp16=True) "
                         "with dynamic loss scaling")
    ap.add_argument("--amp", action="store_true",
                    help="the default; accepted for symmetry")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", type=int, default=0, metavar="N")
    args = ap.parse_args(argv)
    if args.amp and args.no_amp:
        raise SystemExit("train_resnet: --amp and --no-amp contradict")
    if args.tiny:
        args.depth, args.batch, args.image = 18, 4, 32
        args.classes, args.steps = 10, 3
    if args.device != "cpu":
        set_card_precision()
    run = train(args.depth, args.batch, args.image, args.classes, args.steps,
                args.lr, args.device, warmup=args.warmup,
                log_every=args.log_every, amp=not args.no_amp,
                amp_dtype=args.amp_dtype)
    print(f"{args.steps} steps, {run['images_per_s']:.1f} img/s, "
          f"{run['ms_per_step']:.1f} ms/step", flush=True)
    if args.profile:
        print(json.dumps(profile_steps(run, args.profile)))
        print_loss_scaling(run)


def print_loss_scaling(run: dict) -> None:
    """One JSON line of a dynamic-loss-scaling run: the steps that found
    an Inf or a NaN (their updates were skipped) and the scale after
    each step."""
    if "found_inf" in run:
        print(json.dumps({
            "found_inf_steps": [i for i, f in enumerate(run["found_inf"])
                                if f],
            "loss_scaling": run["loss_scaling"]}))


if __name__ == "__main__":
    main()
