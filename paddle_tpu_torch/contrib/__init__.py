"""Contributed modules of the port (counterpart of ``paddle_tpu/contrib``):
so far the AMP op lists of :mod:`.mixed_precision`."""
