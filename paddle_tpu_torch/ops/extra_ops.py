"""The dynamic loss-scaling ops of static float16 AMP (counterpart of
``paddle_tpu/ops/extra_ops.py``: ``amp_check_finite_and_scale`` :190,
``update_loss_scaling`` :204; reference: operators/amp/).

Both run on the device and read nothing back to the host: the found-Inf
flag, the scale and the step counters stay tensors, and a skipped step
is a select, not a branch, so the step never waits on the card.

``amp_check_finite_and_scale`` sees every gradient of the program (161
in ResNet-50).  To keep its launches few whatever that count, it packs
the gradients of one dtype into one flat buffer (one ``cat``), checks and
scales that buffer in one pass each, and hands out views of it as the
outputs: about six launches per dtype, not a few per gradient.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .registry import op

__all__ = []


@op("amp_check_finite_and_scale", no_grad=True)
def _amp_check_finite_and_scale(ctx):
    """``FoundInfinite`` is set when any ``X`` holds an Inf or a NaN; then
    every ``Out`` is zero (a select: ``Inf * 0`` would be NaN), else each
    is ``X * Scale`` in the promoted dtype, as ``jnp`` multiplies."""
    xs = ctx.ins("X")
    scale = ctx.in_("Scale").reshape(())
    groups: Dict[torch.dtype, List[int]] = {}
    for i, x in enumerate(xs):
        groups.setdefault(x.dtype, []).append(i)
    flats = {dt: torch.cat([xs[i].reshape(-1) for i in idx])
             for dt, idx in groups.items()}
    found = torch.zeros((), dtype=torch.bool, device=scale.device)
    for flat in flats.values():
        found = found | ~torch.isfinite(flat).all()
    outs: List[torch.Tensor] = [None] * len(xs)
    for dt, idx in groups.items():
        rt = torch.promote_types(dt, scale.dtype)
        flat = flats[dt].to(rt) * scale.to(rt)
        flat.masked_fill_(found, 0)
        parts = flat.split([xs[i].numel() for i in idx])
        for i, part in zip(idx, parts):
            outs[i] = part.view(xs[i].shape)
    ctx.set_out("FoundInfinite", found.reshape(1))
    ctx.set_out("Out", outs)


@op("update_loss_scaling", no_grad=True)
def _update_loss_scaling(ctx):
    """The dynamic loss-scaling state machine: a found-Inf step zeroes
    the good-step run and adds one to the bad-step run, a clean step the
    other way round; the scale is multiplied by ``decr_ratio`` when the
    bad run reaches ``decr_every_n_nan_or_inf`` and by ``incr_ratio`` when
    the good run reaches ``incr_every_n_steps``, and that run restarts
    from zero.  The scale never falls below 1e-10 (an underflowed scale
    would zero every gradient from then on)."""
    found = ctx.in_("FoundInfinite").reshape(()).to(torch.bool)
    scale = ctx.in_("PrevLossScaling").reshape(())
    good = ctx.in_("InGoodSteps").reshape(())
    bad = ctx.in_("InBadSteps").reshape(())
    incr_n = int(ctx.attr("incr_every_n_steps", 1000))
    decr_n = int(ctx.attr("decr_every_n_nan_or_inf", 2))
    incr_ratio = float(ctx.attr("incr_ratio", 2.0))
    decr_ratio = float(ctx.attr("decr_ratio", 0.5))
    zero = torch.zeros((), dtype=good.dtype, device=good.device)
    good1 = torch.where(found, zero, good + 1)
    bad1 = torch.where(found, bad + 1, zero)
    do_incr = good1 >= incr_n
    do_decr = bad1 >= decr_n
    new_scale = torch.where(do_decr, scale * decr_ratio,
                            torch.where(do_incr, scale * incr_ratio, scale))
    ctx.set_out("LossScalingOut", new_scale.clamp(min=1e-10).reshape(1))
    ctx.set_out("OutGoodSteps", torch.where(do_incr, zero, good1).reshape(1))
    ctx.set_out("OutBadSteps", torch.where(do_decr, zero, bad1).reshape(1))
