"""Mixed precision (counterpart of ``paddle_tpu/contrib/mixed_precision``).

Ported: the op lists (:mod:`.fp16_lists`), which dygraph AMP
(``paddle_tpu_torch.dygraph.amp_guard``) and the static rewrite read; the
static program rewrite (:func:`rewrite_program`, :func:`cast_model_to_fp16`)
and the bf16 optimizer decorator (:func:`decorate`,
:class:`OptimizerWithMixedPrecision`).  float16 with loss scaling is not
ported (ROADMAP.md, slice 8).
"""
from .decorator import OptimizerWithMixedPrecision, decorate  # noqa: F401
from .fp16_lists import (AutoMixedPrecisionLists, black_list,  # noqa: F401
                         gray_list, white_list)
from .fp16_utils import cast_model_to_fp16, rewrite_program  # noqa: F401
