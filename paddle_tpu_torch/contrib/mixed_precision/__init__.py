"""Mixed precision (counterpart of ``paddle_tpu/contrib/mixed_precision``).

Ported: the op lists (:mod:`.fp16_lists`), which dygraph AMP
(``paddle_tpu_torch.dygraph.amp_guard``) reads.  The static program
rewrite (``decorate``, ``rewrite_program``, ``cast_model_to_fp16``) and
loss scaling are not ported (ROADMAP.md).
"""
from .fp16_lists import (AutoMixedPrecisionLists, black_list,  # noqa: F401
                         gray_list, white_list)
