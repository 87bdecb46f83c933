"""AMP op lists: a copy of ``paddle_tpu/amp/amp_lists.py``.

White ops (matrix products, attention) run in the low-precision dtype on
the tensor cores; black ops are numerically sensitive reductions kept in
fp32; every other op is gray and keeps its inputs' dtype (promoted to
fp32 when its float inputs are mixed). The names are the reference's op
names: the port's op entries cast by them (``amp/auto_cast.py``).
"""

# ops that benefit from low precision (matrix products: tensor cores)
WHITE_LIST = {
    "matmul", "linear", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
    "conv2d_transpose", "conv3d_transpose", "bmm", "mm", "mv", "einsum",
    "addmm", "flash_attention", "scaled_dot_product_attention",
}

# numerically dangerous in low precision — always fp32
BLACK_LIST = {
    "exp", "square", "log", "log2", "log10", "log1p", "mean", "sum", "prod",
    "cumsum", "softmax", "log_softmax", "softmax_with_cross_entropy",
    "cross_entropy", "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "nll_loss", "kl_div", "smooth_l1_loss", "mse_loss", "l1_loss",
    "layer_norm", "batch_norm", "instance_norm", "group_norm", "rms_norm",
    "reduce_mean", "reduce_sum", "norm", "cos_sim", "pow", "rsqrt",
    "softplus", "logsumexp", "erfinv", "cholesky", "svd", "eig", "eigh",
    "inverse", "det", "sigmoid_cross_entropy_with_logits", "ctc_loss",
    "margin_cross_entropy", "dist", "renorm",
}

# everything else runs in whichever dtype its inputs already have ("gray")


def white_list():
    return set(WHITE_LIST)


def black_list():
    return set(BLACK_LIST)
