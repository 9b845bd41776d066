"""Contributed modules of the port (counterpart of ``paddle_tpu/contrib``):
so far :mod:`.mixed_precision`, the AMP op lists, the static program
rewrite and the bf16 optimizer decorator."""
from . import mixed_precision  # noqa: F401
