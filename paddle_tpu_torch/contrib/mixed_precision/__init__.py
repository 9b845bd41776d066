"""Mixed precision (counterpart of ``paddle_tpu/contrib/mixed_precision``).

Ported: the op lists (:mod:`.fp16_lists`), which dygraph AMP
(``paddle_tpu_torch.dygraph.amp_guard``) and the static rewrite read; the
static program rewrite (:func:`rewrite_program`, :func:`cast_model_to_fp16`)
and the optimizer decorator (:func:`decorate`,
:class:`OptimizerWithMixedPrecision`): bfloat16, and float16 with static
or dynamic loss scaling (``use_fp16=True``).
"""
from .decorator import OptimizerWithMixedPrecision, decorate  # noqa: F401
from .fp16_lists import (AutoMixedPrecisionLists, black_list,  # noqa: F401
                         gray_list, white_list)
from .fp16_utils import cast_model_to_fp16, rewrite_program  # noqa: F401
