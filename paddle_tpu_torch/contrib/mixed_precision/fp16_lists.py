"""AMP op lists: the port's own copy of
``paddle_tpu/contrib/mixed_precision/fp16_lists.py:1-60`` (reference:
``fluid/contrib/mixed_precision/fp16_lists.py``).

White-list ops run in the low-precision dtype (bfloat16: float32's
exponent range, so no loss scaling), black-list ops in float32, and
gray-list ops in whichever dtype their inputs arrive in.
"""
from __future__ import annotations

__all__ = ["white_list", "black_list", "gray_list",
           "AutoMixedPrecisionLists"]

white_list = {
    "conv2d",
    "depthwise_conv2d",
    "conv3d",
    "conv2d_transpose",
    "matmul",
    "matmul_v2",
    "mul",
    "bmm",
}

black_list = {
    "exp",
    "square",
    "log",
    "mean",
    "sum",
    "cos_sim",
    "softmax",
    "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits",
    "cross_entropy",
    "cross_entropy2",
}

# ops that run in whichever precision their inputs arrive in
gray_list = {
    "elementwise_add", "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_max", "elementwise_min", "elementwise_pow",
    "batch_norm", "layer_norm", "tanh", "sigmoid", "lookup_table",
    "lookup_table_v2", "relu", "relu6", "leaky_relu", "gelu", "swish",
    "top_k", "pool2d", "dropout", "reshape2", "transpose2", "concat", "split",
    "slice", "stack", "unstack", "squeeze2", "unsqueeze2", "flatten2",
    "flatten_contiguous_range", "scale", "expand", "gather", "pad", "pad2d",
    "reduce_mean", "reduce_sum",
}


class AutoMixedPrecisionLists:
    """The three lists, with custom additions: a custom white op leaves
    the black list and a custom black op the white list."""

    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = set(white_list)
        self.black_list = set(black_list)
        self.gray_list = set(gray_list)
        self.black_varnames = set(custom_black_varnames or [])
        if custom_white_list:
            self.white_list |= set(custom_white_list)
            self.black_list -= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
            self.white_list -= set(custom_black_list)
