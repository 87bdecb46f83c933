"""``paddle.nn.functional`` (counterpart of
``paddle_tpu/nn/functional/__init__.py``): every public function of the
reference's namespace, under its name and parameters, plus ``apply``,
the reference's dispatch entry that its ``from .activation import *``
re-exports."""
from .activation import (  # noqa: F401
    apply, celu, elu, elu_, gelu, glu, gumbel_softmax, hardshrink,
    hardsigmoid, hardswish, hardtanh, hardtanh_, leaky_relu, leaky_relu_,
    log_sigmoid, log_softmax, maxout, mish, prelu, relu, relu6, relu_, rrelu,
    selu, sigmoid, silu, softmax, softmax_, softplus, softshrink, softsign,
    swish, tanh, tanh_, tanhshrink, thresholded_relu, thresholded_relu_,
)
from .attention import (  # noqa: F401
    flash_attention, ring_flash_attention, scaled_dot_product_attention,
    sliding_window_attention, ulysses_attention,
)
from .common import (  # noqa: F401
    affine_grid, alpha_dropout, bilinear, channel_shuffle,
    class_center_sample, cosine_similarity, diag_embed, dropout, dropout2d,
    dropout3d, embedding, fold, gather_tree, grid_sample, interpolate,
    label_smooth, linear, normalize, one_hot, pad, pairwise_distance,
    pixel_shuffle, pixel_unshuffle, sequence_mask, sparse_attention,
    temporal_shift, unfold, upsample, zeropad2d,
)
from .conv import (  # noqa: F401
    conv1d, conv1d_transpose, conv2d, conv2d_transpose, conv3d,
    conv3d_transpose,
)
from .loss import (  # noqa: F401
    binary_cross_entropy, binary_cross_entropy_with_logits,
    chunked_softmax_cross_entropy, cosine_embedding_loss, cross_entropy,
    ctc_loss, dice_loss, edit_distance, gaussian_nll_loss,
    hinge_embedding_loss, hsigmoid_loss, huber_loss, kl_div, l1_loss,
    log_loss, margin_cross_entropy, margin_ranking_loss, mse_loss,
    multi_label_soft_margin_loss, multi_margin_loss, nll_loss, npair_loss,
    poisson_nll_loss, rnnt_loss, sigmoid_focal_loss, smooth_l1_loss,
    soft_margin_loss, softmax_with_cross_entropy, square_error_cost,
    triplet_margin_loss, triplet_margin_with_distance_loss,
)
from .norm import (  # noqa: F401
    batch_norm, group_norm, instance_norm, layer_norm, local_response_norm,
    rms_norm,
)
from .pooling import (  # noqa: F401
    adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,
    adaptive_max_pool1d, adaptive_max_pool2d, adaptive_max_pool3d,
    avg_pool1d, avg_pool2d, avg_pool3d, lp_pool2d, max_pool1d, max_pool2d,
    max_pool3d, max_unpool1d, max_unpool2d, max_unpool3d,
)
from . import activation, attention, common, conv, loss, norm, pooling

__all__ = [n for m in (activation, attention, common, conv, loss, norm,
                       pooling) for n in m.__all__]
