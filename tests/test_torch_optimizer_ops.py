"""PyTorch port, the optimizer family's ops against the JAX package's
lowerings on the CPU (``ops/optimizer_ops.py``, ``clip`` /
``clip_by_norm`` / ``sqrt`` / ``squared_l2_norm`` / ``assign``).

* Every variant case of ``tests/torch_optimizer_cases.py`` (LARS's and
  LAMB's zero-norm branches, Adam's first step, AdamW without decay,
  RMSProp centered and with momentum, Ftrl's l1 shrink, ``dpsgd``'s clip,
  ModelAverage's spill at 16384 updates and its window roll, Nesterov's
  fused momentum, ``clip_by_norm`` below its bound): the same numpy
  inputs through both packages' ``registry.run_op``, held to JAX at the
  case's stated tolerance (``ELEMENTWISE`` rtol 1e-6, ``NORMS`` rtol
  1e-5).  Each op type's plain case runs in
  ``tests/test_torch_static_ops.py``'s ``CASES``.
* The fused ops equal the per-parameter ops bit for bit and update the
  input tensors in place.
* ``dpsgd``'s noise: the mean and std of 24,000 draws from an explicit
  generator, and the same draws from the same seed.
* No update op reads a value back to the host or branches on one: each
  runs on ``meta`` tensors, where either would raise.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import registry as treg
from test_torch_static_ops import _check
from torch_optimizer_cases import (CASES, FUSED_ATTRS, FUSED_SLOTS,
                                   first_cases, fused)

VARIANTS = sorted(set(CASES) - set(first_cases()))


@pytest.mark.parametrize("case", VARIANTS)
def test_op_variant_matches_jax(case):
    op_type, ins, outs, attrs, grad_of, tol = CASES[case]
    _check(op_type, ins, outs, attrs, cot_of=grad_of, tol=tol)


def _tensors(ins):
    return {slot: [torch.from_numpy(np.array(v)) for _, v in items]
            for slot, items in ins.items()}


@pytest.mark.parametrize("kind", ["sgd", "momentum", "momentum-nesterov",
                                  "adam"])
def test_fused_op_equals_the_per_parameter_ops(kind):
    """``fused_<type>`` over three parameters against the ``<type>`` op
    run on each: every output equal bit for bit, and the fused op's
    outputs are its input tensors, updated in place."""
    base = kind.split("-")[0]
    attrs = dict(FUSED_ATTRS[base], use_nesterov=True) \
        if kind.endswith("nesterov") else FUSED_ATTRS[base]
    op_type, ins, outs, attrs, _, _ = fused(base, FUSED_SLOTS[base], attrs)
    fused_ins = _tensors(ins)
    got = treg.eager_call(op_type, fused_ins, attrs,
                          {s: len(n) for s, n in outs.items()})
    per = _tensors(ins)
    out_of = {o: i for i, o in zip(
        ["Param", "Velocity", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow"],
        ["ParamOut", "VelocityOut", "Moment1Out", "Moment2Out",
         "Beta1PowOut", "Beta2PowOut"]) if o in outs}
    for k in range(len(ins["Param"])):
        one = {s: [per[s][0] if s == "LearningRate" else per[s][k]]
               for s in per}
        want = treg.eager_call(base, one, attrs, {s: 1 for s in outs})
        for slot, in_slot in out_of.items():
            assert torch.equal(got[slot][k], want[slot][0]), (slot, k)
            assert got[slot][k] is fused_ins[in_slot][k], (slot, k)


def _dpsgd(n, gen, sigma=1.0, clip=2.0):
    """ParamOut of ``dpsgd`` on zero parameters and gradients (no clip,
    lr 1, batch 1): the noise, negated."""
    zeros = torch.zeros(n)
    return treg.eager_call(
        "dpsgd", {"Param": [zeros], "Grad": [zeros.clone()],
                  "LearningRate": [torch.ones(1)]},
        {"clip": clip, "batch_size": 1.0, "sigma": sigma},
        {"ParamOut": 1}, generator=gen)["ParamOut"][0]


def test_dpsgd_noise_moments_and_stream():
    """The noise is N(0, (sigma * clip)^2) from the given generator: its
    mean within 5 standard errors and its std within 5%; the same seed
    draws the same numbers, another seed others."""
    n, std = 24000, 2.0
    noise = -_dpsgd(n, torch.Generator().manual_seed(5))
    assert abs(float(noise.mean())) < 5 * std / n ** 0.5
    assert abs(float(noise.std()) - std) < 0.05 * std
    assert torch.equal(noise, -_dpsgd(n, torch.Generator().manual_seed(5)))
    assert not torch.equal(noise,
                           -_dpsgd(n, torch.Generator().manual_seed(6)))
    # sigma 0: no noise at all
    assert not torch.any(_dpsgd(n, torch.Generator(), sigma=0.0))


_UPDATE_OPS = sorted({CASES[c][0] for c in CASES} - {
    "clip", "clip_by_norm", "sqrt", "squared_l2_norm", "assign"})


@pytest.mark.parametrize("op_type", _UPDATE_OPS)
def test_update_op_never_reads_the_device(op_type):
    """The op's lowering on ``meta`` tensors (no values): an ``.item()``,
    a ``bool()`` of a tensor or a host copy would raise, so the op can be
    captured in a CUDA graph and never stalls the host."""
    name = next(c for c in sorted(CASES) if CASES[c][0] == op_type)
    _, ins, outs, attrs, _, _ = CASES[name]
    meta = {s: [torch.empty(np.shape(v), device="meta",
                            dtype=torch.from_numpy(np.array(v)).dtype)
                for _, v in items] for s, items in ins.items()}
    got = treg.eager_call(op_type, meta, attrs,
                          {s: len(n) for s, n in outs.items()},
                          device=torch.device("meta"))
    assert set(got) <= set(outs)
    for slot, vals in got.items():
        assert len(vals) == len(outs[slot])
        assert all(v.device.type == "meta" for v in vals)
    first = "ParamOut" if "ParamOut" in got else "out_sum_1"
    src = ins["Param" if first == "ParamOut" else "param"]
    assert [tuple(v.shape) for v in got[first]] == \
        [np.shape(a) for _, a in src]
