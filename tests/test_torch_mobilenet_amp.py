"""PyTorch port, MobileNetV3-small static training under ``decorate``
against the JAX package on the CPU (the programs, ops and f32 steps:
``test_torch_mobilenet.py``, whose program and recipe this file reuses).

In bf16 and in fp16 (dynamic loss scaling), one step from JAX's startup
scope copied into the port, at 32x32, batch 4, 10 classes: the step-1
loss within twice the largest move of JAX's own step-1 loss under 1e-6,
1e-5 and 1e-4 relative input noise.  bf16 and fp16 roundings flip at
this size (measured: bf16, the port 4.7% off JAX and JAX's noisy twins
2.7%, 0.07% and 0.8% off; fp16 0.17%, and 0.16%, 0.85%, 0.39%).
``tools/train_mobilenet.py --tiny`` (bf16 AMP by default) trains on the
CPU.
"""
import numpy as np
import pytest

from paddle_tpu.utils import flags as jflags

from test_torch_mobilenet import FUSED, _step_both, fused  # noqa: F401


@pytest.mark.parametrize("amp", ["bfloat16", "float16"])
def test_amp_training_step_matches_jax(fused, monkeypatch, amp):
    """JAX runs unfused: its fused fc grad casts the cotangent to the bf16
    / fp16 of the product while the chain's output is f32 (the f32 bias
    promotes it) and raises; its unfused chain is the same arithmetic
    (``FLAGS_tpu_fuse`` changes no number), as
    ``test_torch_static_amp.py`` holds LeNet."""
    monkeypatch.setitem(jflags._flags, "FLAGS_tpu_fuse", "0")
    jl, tl, _, moves, types = _step_both("small", amp)
    assert types.count("fused_conv_bn_act") == FUSED["small"][0]
    assert np.isfinite(tl)
    assert abs(tl - jl) / abs(jl) <= 2 * max(moves), (jl, tl, moves)
    assert "cast" in types


def test_train_mobilenet_tool_tiny_on_cpu():
    """``tools/train_mobilenet.py --tiny`` (MobileNetV3-small, batch 4,
    32x32, bf16 AMP as the default) trains 3 steps on the CPU."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.train_mobilenet",
         "--tiny", "--device", "cpu", "--warmup", "0", "--log-every", "1"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    losses = [float(ln.split("loss ")[1].split()[0])
              for ln in r.stdout.splitlines() if ln.startswith("step ")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "img/s" in r.stdout
