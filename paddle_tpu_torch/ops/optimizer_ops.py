"""Optimizer update-op lowerings of the static path (counterpart of
``paddle_tpu/ops/optimizer_ops.py``): ``sgd`` :60, ``momentum`` :74,
``lars_momentum`` :106, ``adam`` :127, ``adamw`` :171,
``adamax`` :197, ``adagrad`` :213, ``decayed_adagrad`` :234,
``adadelta`` :246, ``rmsprop`` :261, ``ftrl`` :283, ``lamb`` :302,
``dpsgd`` :330, ``average_accumulates`` :352, and the multi-parameter
forms ``fused_sgd``, ``fused_momentum`` and ``fused_adam`` :405-466 that
``fuse_optimizer_ops_pass`` (``framework/ir.py``) writes.

An update op's ``ParamOut`` carries the ``Param``'s var name (and each
accumulator's output its input's), so the executor writes the new values
back into the scope's own tensors, in place.  The fused forms update the
scope's tensors in place themselves, with ``torch._foreach_*`` ops over
the slot lists.  Each does the per-parameter op's arithmetic in the
same order, one rounding per operation (no ``alpha=`` / ``addcmul``
forms, which a kernel may contract into a fused multiply-add), so a
fused step equals the unfused one bit for bit.

Every data-dependent choice (LARS's and LAMB's zero-norm branch,
``dpsgd``'s clip, ModelAverage's spill and roll on ``[1]`` int64
counters) is a ``torch.where`` on device tensors: no update op reads a
value back to the host, so a step can be captured in a CUDA graph.
``dpsgd`` draws its noise from the executor's generator (the numbers are
not JAX's, as with ``dropout``).  The norms are whole-parameter norms:
JAX's cross-shard ``psum`` (:23-56) belongs to the data-parallel path,
which the port does not have.  ``sgd``, ``momentum``, ``adam`` and
``adagrad`` also take a SelectedRows gradient (a sparse embedding's,
``framework/selected_rows.py``): ``sgd`` adds into the selected rows
(duplicates summed); ``momentum``, ``adagrad`` and ``adam`` under
``lazy_mode`` merge the duplicates first and update only the touched
rows of the parameter and its accumulators; ``adam`` without
``lazy_mode`` decays every row's moments, so it takes the dense
gradient (JAX :60-160, :213-229).  All are no_grad.
"""
from __future__ import annotations

from typing import List

import torch

from ..framework.selected_rows import (SelectedRows, add_rows, gather_rows,
                                       scatter_rows)
from .registry import op

__all__ = []


def _opt(type):
    return op(type, no_grad=True)


def _lr(ctx, dtype):
    return ctx.in_("LearningRate").reshape(()).to(dtype)


def _grad(ctx, p):
    g = ctx.in_("Grad")
    return g if g.dtype == p.dtype else g.to(p.dtype)


def _param_norm(x):
    """sqrt(sum(x^2)) over the whole tensor."""
    return torch.sqrt((x * x).sum())


def _sparse_grad(ctx, p):
    """A SelectedRows ``Grad`` merged (duplicates summed) and in p's
    dtype: (the merged rows, their values)."""
    m = ctx.in_("Grad").merge_rows()
    return m, m.values.to(p.dtype)


@_opt("sgd")
def _sgd(ctx):
    p = ctx.in_("Param")
    g = ctx.in_("Grad")
    if isinstance(g, SelectedRows):
        # only the selected rows move; duplicates add in turn
        ctx.set_out("ParamOut", add_rows(
            p.clone(), g, -_lr(ctx, p.dtype) * g.values.to(p.dtype)))
        return
    ctx.set_out("ParamOut", p - _lr(ctx, p.dtype) * _grad(ctx, p))


@_opt("momentum")
def _momentum(ctx):
    """``v = mu * v + g``; ``p -= lr * v`` (or, Nesterov,
    ``p -= (g + mu * v) * lr``)."""
    p, v = ctx.in_("Param"), ctx.in_("Velocity")
    mu = ctx.attr("mu", 0.9)
    if isinstance(ctx.in_("Grad"), SelectedRows):
        # lazy: the untouched rows keep their velocity
        m, g = _sparse_grad(ctx, p)
        lr = _lr(ctx, p.dtype)
        v_rows = mu * gather_rows(v, m) + g
        if ctx.attr("use_nesterov", False):
            upd = (g + mu * v_rows) * lr
        else:
            upd = lr * v_rows
        ctx.set_out("ParamOut", scatter_rows(p, m, gather_rows(p, m) - upd))
        ctx.set_out("VelocityOut", scatter_rows(v, m, v_rows))
        return
    g, lr = _grad(ctx, p), _lr(ctx, p.dtype)
    v_new = mu * v + g
    if ctx.attr("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    ctx.set_out("ParamOut", p_new)
    ctx.set_out("VelocityOut", v_new)


@_opt("lars_momentum")
def _lars_momentum(ctx):
    """Layer-wise rate ``lr * coeff * |p| / (|g| + wd * |p| + eps)``
    where both norms are positive, else ``lr``; then
    ``v = mu * v + local_lr * (g + wd * p)``, ``p -= v``."""
    p, v = ctx.in_("Param"), ctx.in_("Velocity")
    g, lr = _grad(ctx, p), _lr(ctx, p.dtype)
    mu = ctx.attr("mu", 0.9)
    coeff = ctx.attr("lars_coeff", 0.001)
    wd = ctx.attr("lars_weight_decay", 0.0005)
    eps = ctx.attr("epsilon", 0.0)
    p_norm, g_norm = _param_norm(p), _param_norm(g)
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * coeff * p_norm / (g_norm + wd * p_norm + eps), lr)
    v_new = mu * v + local_lr * (g + wd * p)
    ctx.set_out("ParamOut", p - v_new)
    ctx.set_out("VelocityOut", v_new)


def _adam_moments(ctx, p, g):
    """Adam's bias-corrected rate and new moments (JAX :127-165)."""
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    b1p, b2p = ctx.in_("Beta1Pow"), ctx.in_("Beta2Pow")
    lr = _lr(ctx, p.dtype)
    lr_t = (lr * torch.sqrt(1 - b2p.reshape(()).to(p.dtype) * b2)
            / (1 - b1p.reshape(()).to(p.dtype) * b1))
    m1_new = b1 * ctx.in_("Moment1") + (1 - b1) * g
    m2_new = b2 * ctx.in_("Moment2") + (1 - b2) * (g * g)
    return lr_t, m1_new, m2_new


def _set_adam_outs(ctx, p_new, m1_new, m2_new):
    ctx.set_out("ParamOut", p_new)
    ctx.set_out("Moment1Out", m1_new)
    ctx.set_out("Moment2Out", m2_new)
    ctx.set_out("Beta1PowOut", ctx.in_("Beta1Pow") * ctx.attr("beta1", 0.9))
    ctx.set_out("Beta2PowOut", ctx.in_("Beta2Pow") * ctx.attr("beta2", 0.999))


@_opt("adam")
def _adam(ctx):
    """Paddle's Adam: epsilon added to the uncorrected ``sqrt(v)``, the
    beta powers advanced after the update.  A SelectedRows gradient is
    densified (every row's moments decay) unless ``lazy_mode``, where
    only the touched rows' moments and values change."""
    p = ctx.in_("Param")
    eps = ctx.attr("epsilon", 1e-8)
    g = ctx.in_("Grad")
    if isinstance(g, SelectedRows) and not ctx.attr("lazy_mode", False):
        g = g.to_dense()
    if isinstance(g, SelectedRows):
        m, gv = _sparse_grad(ctx, p)
        b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
        b1p, b2p = ctx.in_("Beta1Pow"), ctx.in_("Beta2Pow")
        lr_t = (_lr(ctx, p.dtype) * torch.sqrt(
            1 - b2p.reshape(()).to(p.dtype) * b2)
            / (1 - b1p.reshape(()).to(p.dtype) * b1))
        m1_r = b1 * gather_rows(ctx.in_("Moment1"), m) + (1 - b1) * gv
        m2_r = b2 * gather_rows(ctx.in_("Moment2"), m) + (1 - b2) * (gv * gv)
        upd = lr_t * m1_r / (torch.sqrt(m2_r) + eps)
        _set_adam_outs(ctx, scatter_rows(p, m, gather_rows(p, m) - upd),
                       scatter_rows(ctx.in_("Moment1"), m, m1_r),
                       scatter_rows(ctx.in_("Moment2"), m, m2_r))
        return
    g = g if g.dtype == p.dtype else g.to(p.dtype)
    lr_t, m1_new, m2_new = _adam_moments(ctx, p, g)
    _set_adam_outs(ctx, p - lr_t * m1_new / (torch.sqrt(m2_new) + eps),
                   m1_new, m2_new)


@_opt("adamw")
def _adamw(ctx):
    """Adam on the decoupled-decayed parameter ``p * (1 - lr * coeff)``."""
    p = ctx.in_("Param")
    if ctx.attr("with_decay", True):
        p = p * (1.0 - _lr(ctx, p.dtype) * ctx.attr("coeff", 0.01))
    eps = ctx.attr("epsilon", 1e-8)
    lr_t, m1_new, m2_new = _adam_moments(ctx, p, _grad(ctx, p))
    _set_adam_outs(ctx, p - lr_t * m1_new / (torch.sqrt(m2_new) + eps),
                   m1_new, m2_new)


@_opt("adamax")
def _adamax(ctx):
    """``m = b1 m + (1 - b1) g``, ``u = max(b2 u, |g|)``,
    ``p -= lr / (1 - b1p) * m / (u + eps)``; the beta power advances in
    a ``scale`` op the optimizer appends."""
    p = ctx.in_("Param")
    g = _grad(ctx, p)
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    m_new = b1 * ctx.in_("Moment") + (1 - b1) * g
    inf_new = torch.maximum(b2 * ctx.in_("InfNorm"), torch.abs(g))
    lr_t = _lr(ctx, p.dtype) / (1 - ctx.in_("Beta1Pow").reshape(()))
    ctx.set_out("ParamOut", p - lr_t * m_new / (inf_new + eps))
    ctx.set_out("MomentOut", m_new)
    ctx.set_out("InfNormOut", inf_new)


@_opt("adagrad")
def _adagrad(ctx):
    """``m += g^2``; ``p -= lr * g / (sqrt(m) + eps)`` (on the touched
    rows only for a SelectedRows gradient)."""
    p = ctx.in_("Param")
    if isinstance(ctx.in_("Grad"), SelectedRows):
        m, g = _sparse_grad(ctx, p)
        m_r = gather_rows(ctx.in_("Moment"), m) + g * g
        upd = _lr(ctx, p.dtype) * g / (torch.sqrt(m_r)
                                       + ctx.attr("epsilon", 1e-6))
        ctx.set_out("ParamOut", scatter_rows(p, m, gather_rows(p, m) - upd))
        ctx.set_out("MomentOut", scatter_rows(ctx.in_("Moment"), m, m_r))
        return
    g = _grad(ctx, p)
    m_new = ctx.in_("Moment") + g * g
    ctx.set_out("ParamOut", p - _lr(ctx, p.dtype) * g
                / (torch.sqrt(m_new) + ctx.attr("epsilon", 1e-6)))
    ctx.set_out("MomentOut", m_new)


@_opt("decayed_adagrad")
def _decayed_adagrad(ctx):
    p = ctx.in_("Param")
    g = _grad(ctx, p)
    decay = ctx.attr("decay", 0.95)
    m_new = decay * ctx.in_("Moment") + (1 - decay) * (g * g)
    ctx.set_out("ParamOut", p - _lr(ctx, p.dtype) * g
                / (torch.sqrt(m_new) + ctx.attr("epsilon", 1e-6)))
    ctx.set_out("MomentOut", m_new)


@_opt("adadelta")
def _adadelta(ctx):
    p = ctx.in_("Param")
    g = _grad(ctx, p)
    rho, eps = ctx.attr("rho", 0.95), ctx.attr("epsilon", 1e-6)
    avg_sq_g_new = rho * ctx.in_("AvgSquaredGrad") + (1 - rho) * (g * g)
    avg_sq_u = ctx.in_("AvgSquaredUpdate")
    update = -torch.sqrt((avg_sq_u + eps) / (avg_sq_g_new + eps)) * g
    ctx.set_out("ParamOut", p + update)
    ctx.set_out("AvgSquaredGradOut", avg_sq_g_new)
    ctx.set_out("AvgSquaredUpdateOut",
                rho * avg_sq_u + (1 - rho) * (update * update))


@_opt("rmsprop")
def _rmsprop(ctx):
    """Mean square ``ms = decay ms + (1 - decay) g^2``; ``centered``
    subtracts the squared mean gradient ``mg`` (then an input); the
    step goes through a momentum buffer: ``mom = momentum mom + lr g /
    sqrt(ms [- mg^2] + eps)``, ``p -= mom``."""
    p = ctx.in_("Param")
    g = _grad(ctx, p)
    lr = _lr(ctx, p.dtype)
    eps, decay = ctx.attr("epsilon", 1e-10), ctx.attr("decay", 0.9)
    momentum = ctx.attr("momentum", 0.0)
    ms_new = decay * ctx.in_("MeanSquare") + (1 - decay) * (g * g)
    if ctx.attr("centered", False):
        mg_new = decay * ctx.in_("MeanGrad") + (1 - decay) * g
        denom = torch.sqrt(ms_new - mg_new * mg_new + eps)
        ctx.set_out("MeanGradOut", mg_new)
    else:
        denom = torch.sqrt(ms_new + eps)
    mom_new = momentum * ctx.in_("Moment") + lr * g / denom
    ctx.set_out("ParamOut", p - mom_new)
    ctx.set_out("MeanSquareOut", ms_new)
    ctx.set_out("MomentOut", mom_new)


@_opt("ftrl")
def _ftrl(ctx):
    p = ctx.in_("Param")
    g = _grad(ctx, p)
    sq, lin = ctx.in_("SquaredAccumulator"), ctx.in_("LinearAccumulator")
    lr = _lr(ctx, p.dtype)
    l1, l2 = ctx.attr("l1", 0.0), ctx.attr("l2", 0.0)
    power = -ctx.attr("lr_power", -0.5)
    new_sq = sq + g * g
    sigma = (torch.pow(new_sq, power) - torch.pow(sq, power)) / lr
    new_lin = lin + g - sigma * p
    pre_shrink = (torch.sign(new_lin) * l1 - new_lin) / (
        torch.pow(new_sq, power) / lr + 2 * l2)
    ctx.set_out("ParamOut", torch.where(torch.abs(new_lin) > l1, pre_shrink,
                                        torch.zeros_like(p)))
    ctx.set_out("SquaredAccumOut", new_sq)
    ctx.set_out("LinearAccumOut", new_lin)


@_opt("lamb")
def _lamb(ctx):
    """Adam's moments bias-corrected with the post-update beta powers,
    ``r = m1_hat / (sqrt(m2_hat) + eps) + wd * p``, and the trust ratio
    ``|p| / |r|`` where both norms are positive, else 1."""
    p = ctx.in_("Param")
    g = _grad(ctx, p)
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps, wd = ctx.attr("epsilon", 1e-6), ctx.attr("weight_decay", 0.01)
    m1_new = b1 * ctx.in_("Moment1") + (1 - b1) * g
    m2_new = b2 * ctx.in_("Moment2") + (1 - b2) * (g * g)
    m1_hat = m1_new / (1 - ctx.in_("Beta1Pow").reshape(()) * b1)
    m2_hat = m2_new / (1 - ctx.in_("Beta2Pow").reshape(()) * b2)
    r = m1_hat / (torch.sqrt(m2_hat) + eps) + wd * p
    w_norm, r_norm = _param_norm(p), _param_norm(r)
    ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)
    _set_adam_outs(ctx, p - _lr(ctx, p.dtype) * ratio * r, m1_new, m2_new)


@_opt("dpsgd")
def _dpsgd(ctx):
    """Differentially private SGD: the gradient clipped to norm ``clip``,
    plus Gaussian noise of std ``sigma * clip`` drawn from the executor's
    generator, over ``batch_size``."""
    p = ctx.in_("Param")
    g = _grad(ctx, p)
    clip = ctx.attr("clip", 10.0)
    batch_size, sigma = ctx.attr("batch_size", 16.0), ctx.attr("sigma", 1.0)
    g_norm = torch.sqrt((g * g).sum())
    g = torch.where(g_norm > clip, g * (clip / g_norm), g)
    noise = torch.randn(g.shape, generator=ctx.rng(), dtype=g.dtype,
                        device=g.device)
    noise = sigma * clip * noise
    ctx.set_out("ParamOut", p - _lr(ctx, p.dtype) * (g + noise) / batch_size)


@_opt("average_accumulates")
def _average_accumulates(ctx):
    """ModelAverage's windowed sums: ``sum_1`` accumulates the parameter,
    spills into ``sum_2`` every 16384 updates, and when the window
    (``min(max_average_window, num_updates * average_window)``, at least
    ``min_average_window``) is full the sums move to ``sum_3`` and
    restart.  The ``[1]`` counters are int tensors; both branches are
    ``torch.where``."""
    param = ctx.in_("param")
    s1, s2, s3 = ctx.in_("in_sum_1"), ctx.in_("in_sum_2"), ctx.in_("in_sum_3")
    num_acc = ctx.in_("in_num_accumulates").reshape(())
    old_num = ctx.in_("in_old_num_accumulates").reshape(())
    num_upd = ctx.in_("in_num_updates").reshape(())
    avg_window = ctx.attr("average_window", 0.0)
    max_w = ctx.attr("max_average_window", 10000)
    min_w = ctx.attr("min_average_window", 10000)
    k_max = 16384

    num_upd = num_upd + 1
    num_acc = num_acc + 1
    s1 = s1 + param

    spill = (num_upd % k_max) == 0
    s2 = torch.where(spill, s2 + s1, s2)
    s1 = torch.where(spill, torch.zeros_like(s1), s1)

    window = (num_upd.to(torch.float32) * avg_window).to(
        num_upd.dtype).clamp(max=max_w)
    roll = (num_acc >= min_w) & (num_acc >= window)
    s3 = torch.where(roll, s1 + s2, s3)
    s1 = torch.where(roll, torch.zeros_like(s1), s1)
    s2 = torch.where(roll, torch.zeros_like(s2), s2)
    old_num = torch.where(roll, num_acc, old_num)
    num_acc = torch.where(roll, torch.zeros_like(num_acc), num_acc)

    ctx.set_out("out_sum_1", s1)
    ctx.set_out("out_sum_2", s2)
    ctx.set_out("out_sum_3", s3)
    ctx.set_out("out_num_accumulates", num_acc.reshape(1))
    ctx.set_out("out_old_num_accumulates", old_num.reshape(1))
    ctx.set_out("out_num_updates", num_upd.reshape(1))


# --------------------------------------------------------------------------
# the fused forms (JAX :395-466; reference: ir/fuse_optimizer_ops_pass/):
# one op over parallel slot lists, updating the scope's tensors in place
# --------------------------------------------------------------------------
def _fused_slots(ctx, *slots) -> List[List[torch.Tensor]]:
    """The Param list, the Grad list in the params' dtypes, then the other
    ``slots``' lists."""
    ps = ctx.ins("Param")
    gs = [g if g.dtype == p.dtype else g.to(p.dtype)
          for p, g in zip(ps, ctx.ins("Grad"))]
    return [ps, gs] + [ctx.ins(s) for s in slots]


def _fused_lr(ctx, ps):
    dts = {p.dtype for p in ps}
    if len(dts) != 1:
        raise TypeError(f"{ctx.op.type if ctx.op else 'fused op'}: the "
                        f"parameters' dtypes differ: {sorted(map(str, dts))}")
    return ctx.in_("LearningRate").reshape(()).to(dts.pop())


@_opt("fused_sgd")
def _fused_sgd(ctx):
    ps, gs = _fused_slots(ctx)
    torch._foreach_sub_(ps, torch._foreach_mul(gs, _fused_lr(ctx, ps)))
    ctx.set_out("ParamOut", ps)


@_opt("fused_momentum")
def _fused_momentum(ctx):
    ps, gs, vs = _fused_slots(ctx, "Velocity")
    lr = _fused_lr(ctx, ps)
    mu = ctx.attr("mu", 0.9)
    torch._foreach_mul_(vs, mu)
    torch._foreach_add_(vs, gs)                 # v = mu * v + g
    if ctx.attr("use_nesterov", False):
        step = torch._foreach_mul(vs, mu)
        torch._foreach_add_(step, gs)           # g + mu * v
        torch._foreach_mul_(step, lr)
    else:
        step = torch._foreach_mul(vs, lr)
    torch._foreach_sub_(ps, step)
    ctx.set_out("ParamOut", ps)
    ctx.set_out("VelocityOut", vs)


@_opt("fused_adam")
def _fused_adam(ctx):
    ps, gs, m1s, m2s, b1ps, b2ps = _fused_slots(
        ctx, "Moment1", "Moment2", "Beta1Pow", "Beta2Pow")
    lr = _fused_lr(ctx, ps)
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    # each parameter's bias-corrected rate, elementwise over its powers
    b1p = torch.cat([b.reshape(1) for b in b1ps]).to(lr.dtype)
    b2p = torch.cat([b.reshape(1) for b in b2ps]).to(lr.dtype)
    lr_t = lr * torch.sqrt(1 - b2p * b2) / (1 - b1p * b1)
    torch._foreach_mul_(m1s, b1)
    torch._foreach_add_(m1s, torch._foreach_mul(gs, 1 - b1))
    sq = torch._foreach_mul(gs, gs)
    torch._foreach_mul_(sq, 1 - b2)
    torch._foreach_mul_(m2s, b2)
    torch._foreach_add_(m2s, sq)
    step = torch._foreach_mul(m1s, list(lr_t.unbind()))
    denom = torch._foreach_sqrt(m2s)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(step, denom)
    torch._foreach_sub_(ps, step)
    torch._foreach_mul_(b1ps, b1)
    torch._foreach_mul_(b2ps, b2)
    ctx.set_out("ParamOut", ps)
    ctx.set_out("Moment1Out", m1s)
    ctx.set_out("Moment2Out", m2s)
    ctx.set_out("Beta1PowOut", b1ps)
    ctx.set_out("Beta2PowOut", b2ps)
