"""Dygraph (imperative) mode of the port: layers as ``nn.Module``s, torch
autograd for the tape, AMP (``amp_guard``), and the eager train step."""
from .amp import amp_cast  # noqa: F401
from .base import amp_guard, auto_cast  # noqa: F401
from .jit import jit_train_step, to_tensor  # noqa: F401
from .layers import (Layer, LayerList, create_parameter,  # noqa: F401
                     load_state_dict_numpy)
from .nn import Dropout, Embedding, LayerNorm, Linear  # noqa: F401
