"""Op lowerings of the port: plain PyTorch, and the wrappers of the
hand-written CUDA kernels with their plain versions.

Importing the package registers the static path's op lowerings with
:mod:`.registry`."""
from . import registry  # noqa: F401
from . import (extra_ops, fused_ops, math_ops, nn_ops,  # noqa: F401
               optimizer_ops, sampling_ops, sequence_ops, tensor_ops)
