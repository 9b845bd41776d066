"""The ``fluid`` namespace of the port (counterpart of
``paddle_tpu/fluid/__init__.py``), for the static path: a reference-era
script runs with ``import paddle_tpu_torch.fluid as fluid``.  Ported:
what a ResNet training script uses."""
from .. import initializer, layers, optimizer  # noqa: F401
from ..backward import append_backward, gradients  # noqa: F401
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
