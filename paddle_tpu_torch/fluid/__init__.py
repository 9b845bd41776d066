"""The ``fluid`` namespace of the port (counterpart of
``paddle_tpu/fluid/__init__.py``), for the static path: a reference-era
script runs with ``import paddle_tpu_torch.fluid as fluid``.  Ported:
what a ResNet, MobileNetV3 or static BERT encoder training script uses
(``fluid.data``, ``fluid.embedding``, ``fluid.one_hot``, weight decay
from ``fluid.regularizer``, the schedules of ``fluid.layers``, every
static optimizer of ``fluid.optimizer``, gradient clipping from
``fluid.clip``),
with ``fluid.contrib.mixed_precision.decorate`` for bf16 AMP, or fp16 AMP
with loss scaling (``use_fp16=True``)."""
from .. import (clip, contrib, initializer, layers,  # noqa: F401
                optimizer, regularizer)
from ..backward import append_backward, gradients  # noqa: F401
from ..clip import (GradientClipByGlobalNorm,  # noqa: F401
                    GradientClipByNorm, GradientClipByValue)
from ..executor import Executor  # noqa: F401
from ..framework import unique_name  # noqa: F401
from ..framework.core import (Block, Operator, Program,  # noqa: F401
                              Variable, default_main_program,
                              default_startup_program, name_scope,
                              program_guard)
from ..framework.dtype import VarType  # noqa: F401
from ..framework.place import (CPUPlace, CUDAPlace,  # noqa: F401
                               is_compiled_with_cuda)
from ..framework.scope import Scope, global_scope, scope_guard  # noqa: F401
from ..param_attr import ParamAttr  # noqa: F401
from ..utils.flags import get_flag, set_flags  # noqa: F401


def data(name, shape, dtype="float32", lod_level=0):
    """A feed variable of exactly ``shape`` (-1 for a dynamic dim), as
    ``fluid.data`` (JAX ``fluid/__init__.py:80``)."""
    return layers.data(name, shape, dtype=dtype, lod_level=lod_level,
                       append_batch_size=False)


embedding = layers.embedding
one_hot = layers.one_hot
