"""``Layer`` and ``LayerList`` on top of ``torch.nn.Module`` (counterpart
of ``paddle_tpu/dygraph/layers.py:20-205``).

Parameters are ``nn.Parameter``s registered in attribute order, so
``named_parameters()`` and ``state_dict()`` give the JAX model's dotted
names (``bert.encoder.0.attn.q.weight``) in the JAX model's order, and
the layouts are Paddle's (``Linear.weight`` is ``[in, out]``): a JAX
model's weights load one to one with :func:`load_state_dict_numpy`.
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch
from torch import nn

from ..framework.place import resolve_device
from ..framework.random import default_generator
from ..initializer import ConstantInitializer, XavierInitializer
from ..param_attr import ParamAttr

__all__ = ["Layer", "LayerList", "create_parameter", "load_state_dict_numpy"]


def create_parameter(attr, shape, is_bias=False, default_initializer=None,
                     dtype="float32", device="cuda", generator=None):
    """A new ``nn.Parameter`` of ``shape`` on ``device``, filled by the
    attr's initializer (else ``default_initializer``, else zeros for a
    bias and Xavier for a weight) from ``generator``; None when ``attr``
    is False."""
    attr = ParamAttr._to_attr(attr)
    if attr is None:
        return None
    if str(dtype) not in ("float32", "torch.float32"):
        raise NotImplementedError(f"parameters of dtype {dtype} are not "
                                  f"ported (float32 only)")
    dev = resolve_device(device)
    init = attr.initializer or default_initializer or (
        ConstantInitializer(0.0) if is_bias else XavierInitializer())
    data = torch.empty([int(s) for s in shape], dtype=torch.float32,
                       device=dev)
    init(data, generator if generator is not None
         else default_generator(dev))
    param = nn.Parameter(data, requires_grad=attr.trainable)
    if attr.regularizer is not None:
        param.regularizer = attr.regularizer
    return param


def _as_tensor(x) -> torch.Tensor:
    """A tensor of ``x``.  A numpy bfloat16 array (``ml_dtypes``' type, as
    the JAX package's bf16 arrays come out of ``np.asarray``) is carried
    by its bits: torch reads no such dtype."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.as_tensor(a)


class Layer(nn.Module):
    """A dygraph layer: an ``nn.Module`` with Paddle's method names."""

    def parameters(self, include_sublayers=True) -> List[nn.Parameter]:
        return list(super().parameters(recurse=include_sublayers))

    def set_dict(self, state_dict: Mapping):
        """Copy, in place, every entry of ``state_dict`` (numpy arrays,
        bfloat16 ones included, or tensors) whose name this layer has,
        cast to the parameter's dtype (bf16 under AMP O2); other names
        are skipped."""
        own = dict(self.named_parameters())
        own.update(self.named_buffers())
        with torch.no_grad():
            for name, t in own.items():
                if name in state_dict:
                    t.copy_(_as_tensor(state_dict[name]))
        return self

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None


class LayerList(Layer):
    """Sublayers named "0", "1", ... in order."""

    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or []):
            self.add_module(str(i), layer)

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)


def load_state_dict_numpy(model: Layer, arrays: Dict[str, np.ndarray]):
    """Load ``{name: np.ndarray}`` into ``model`` one to one, with no
    transposes (both packages keep Paddle's layouts): for example
    ``{k: np.asarray(v.value()) for k, v in jax_model.state_dict().items()}``.
    Raises unless the names and shapes are exactly the model's."""
    own = model.state_dict()
    if set(own) != set(arrays):
        raise KeyError(f"state names differ: missing "
                       f"{sorted(set(own) - set(arrays))}, unexpected "
                       f"{sorted(set(arrays) - set(own))}")
    for name, t in own.items():
        if tuple(np.shape(arrays[name])) != tuple(t.shape):
            raise ValueError(f"{name}: shape {np.shape(arrays[name])} != "
                             f"{tuple(t.shape)}")
    model.set_dict(arrays)
    return model
