"""PyTorch port, ResNet static training against the JAX package.

Both packages build the same program (``tests/test_torch_static_core.py``
pins that); the JAX startup program runs once and its scope (weights,
BatchNorm statistics, velocities, learning rate) is copied into the
port's, since the two random streams never match; both then train
``STEPS`` Momentum steps on the same numpy feed (seed 0, as the example
draws it).  Fusion is forced on in both (the JAX Pallas epilogue kernels
in interpret mode, the port's kernels' plain versions on the CPU) and
off in both.

The tolerances (``torch_resnet_parity.py``).  A deep, untrained BN+ReLU net at batch 4 is chaotic: f32
reduction-order noise flips ReLU masks and BatchNorm over a few values
per channel (1x1 or 2x2 maps in the last stage) magnifies it
(``__graft_entry__.py:187-198``).  Measured on the JAX package alone at
the oracle size (ResNet-50, 32x32): input noise of 1e-6 relative moves
its own step-1 loss by 6.1e-4 relative and its gradients by up to 61%.
So:

* step 1's loss within ``LOSS_RTOL[case]``: 1e-5 where the last stage
  keeps its noise down (ResNet-18 at 32x32, and ResNet-50 at 64x64 in
  ``test_torch_static_core.py``), and
  2e-4 at the ResNet-50 oracle size, where the port's two f32 libraries
  (oneDNN convolutions, ATen reductions) differ from XLA's by 7.1e-5
  while 1e-6 of input noise moves JAX itself by 6.1e-4;
* every parameter and velocity (the step-1 gradient) after step 1,
  each tensor's largest difference relative to its largest magnitude:
  for ResNet-18 within ``AFTER1_TOL`` (measured 1.3e-4 and 1.8e-4); for
  ResNet-50, whose gradients the chaos scrambles, within twice what
  1e-6 relative input noise does to the JAX package's own step (a
  second JAX run from the same scope);
* later steps within ``__graft_entry__.py:204-207``'s envelope,
  ``max(1e-3, 0.2 |loss|)``.
"""
import subprocess
import sys

import numpy as np
import pytest

from torch_resnet_parity import (PORT, ROOT, STEPS, TScope, build,
                                 check_training, feed, tfluid, tflags)


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("depth,image", [(18, 32), (50, 32)],
                         ids=["resnet18-32", "resnet50-32"])
def test_training_matches_jax(monkeypatch, depth, image, fuse):
    check_training(depth, image, fuse, monkeypatch)


def test_fusion_changes_no_number_in_the_port(monkeypatch):
    """FLAGS_cuda_fuse flips where the epilogue runs, not the numbers: on
    the CPU (plain versions) the fused and unfused programs give the same
    losses bit for bit, as JAX's FLAGS_tpu_fuse contract says
    (``fused_ops.py:420-425``)."""
    runs = []
    for fuse in ("0", "1"):
        monkeypatch.setitem(tflags._SET, "FLAGS_cuda_fuse", fuse)
        main, startup, loss, _ = build(PORT, 18, 32)
        scope = TScope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        runs.append([float(exe.run(main, feed=feed(32), fetch_list=[loss],
                                   scope=scope)[0]) for _ in range(STEPS)])
    assert runs[0] == runs[1]


def test_train_resnet_tool_tiny_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.train_resnet",
         "--tiny", "--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("step ")]
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in lines]
    # steps 0 and 2 are printed (every 10th step and the last)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "img/s" in r.stdout
