"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package grows
beside it slice by slice and imports nothing of it (nor ``jax``).  The
ported slice so far is the decode-serving path: ``ServingEngine`` over a
paged KV cache, whose paged-decode attention is a hand-written CUDA
kernel for Hopper (``csrc/paged_attention.cu``).

Entry points run on the CUDA device by default and raise when there is
none, unless the caller passes ``device="cpu"``; CPU tensors take each
kernel's plain PyTorch version.
"""
from .inference.serving import (  # noqa: F401
    DecoderConfig, DecoderLM, Request, RequestRejected, ServingEngine,
    StepEvent, decoder_param_specs, init_decoder_weights,
    load_decoder_config, load_decoder_weights,
)
