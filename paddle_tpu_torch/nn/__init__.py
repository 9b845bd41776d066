"""The ``paddle.nn`` namespace of the port (counterpart of
``paddle_tpu/nn/``): only :mod:`.functional` so far; the Layer classes
are ``paddle_tpu_torch.dygraph``'s."""
from . import functional  # noqa: F401
from . import functional as F  # noqa: F401
