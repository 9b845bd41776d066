"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package grows
beside it slice by slice and imports nothing of it (nor ``jax``).  The
ported slices so far:

* decode serving: ``ServingEngine`` over a paged KV cache in float32,
  bfloat16 or int8, with a copy-on-write prefix cache and chunked
  prefill, greedy, sampled (``SamplingParams``) and speculative decoding,
  ``fifo`` and ``slo_aware`` admission, the ``StaticBatchingEngine``
  baseline, telemetry, request tracing and serving chaos faults, whose
  paged-decode attention is a hand-written CUDA kernel for Hopper
  (``csrc/paged_attention.cu``);
* BERT/ERNIE-base dygraph pretraining in float32: ``BertForPretraining``,
  ``AdamOptimizer`` and ``dygraph.jit_train_step``, whose attention runs in
  hand-written flash-attention kernels, forward and backward
  (``csrc/flash_attention.cu``).

Entry points run on the CUDA device by default and raise when there is
none, unless the caller passes ``device="cpu"``; CPU tensors take each
kernel's plain PyTorch version.
"""
from .inference.serving import (  # noqa: F401
    DecoderConfig, DecoderLM, Request, RequestRejected, SamplingParams,
    ServingEngine, StaticBatchingEngine, StepEvent, decoder_param_specs,
    init_decoder_weights, load_decoder_config, load_decoder_weights,
)
from .models.bert import (  # noqa: F401
    BertConfig, BertForPretraining, BertModel, ErnieConfig, ErnieModel,
)
from .optimizer import AdamOptimizer  # noqa: F401
