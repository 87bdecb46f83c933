"""The tables of the port's ``nn.functional`` tests, free of JAX.

``tests/test_torch_functional_ops.py`` runs the rows against the
reference on the CPU; ``chip_smoke.py`` phase 24 and
``tests/test_torch_gpu.py -k functional`` run them on the card against
the port's own CPU results. A row is ``Row(id, call, inputs, grad, tol,
card_tol)``: ``call(F, *xs)`` drives either package's ``nn.functional``
(``F`` is ``paddle_tpu.nn.functional``, ``paddle_tpu_torch.nn.functional``
or a :class:`Recorder` of the latter) on the numpy ``inputs`` made
tensors by that package's ``to_tensor``; ``grad`` names the inputs whose
gradient is held (of ``sum(out * cotangent)`` over the float outputs,
the cotangents seeded by :func:`cotangents`); ``tol`` bounds the
distance from the reference relative to the largest magnitude (values
and gradients), ``card_tol`` the card's distance from the CPU where it
differs from ``CARD_TOL`` (its reason beside it). :func:`covered` names
every function these tables call, as a recorder of the port sees them
resolved while the rows and the random draws run.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.framework.device import using_device
from torch_tensor_cases import Recorder

# the card against the CPU in fp32, relative to an output's largest
# magnitude: the order of the sums (TF32 off)
CARD_TOL = 1e-5

_R = np.random.RandomState(41)


def f32(*shape, lo=-1.0, hi=1.0):
    return _R.uniform(lo, hi, shape).astype(np.float32)


def ints(*shape, lo=0, hi=10):
    return _R.randint(lo, hi, shape).astype(np.int64)


class Row(NamedTuple):
    id: str
    call: object
    inputs: tuple
    grad: tuple = ()
    tol: float = 1e-5
    card_tol: float = CARD_TOL


X = f32(3, 4)
XNZ = (np.sign(X) * (np.abs(X) + 0.1)).astype(np.float32)  # no kink at 0
X4 = f32(2, 4, 5, 6)
X5 = f32(2, 3, 4, 5, 3)
X3 = f32(2, 3, 7)
P = f32(3, 4, lo=0.1, hi=0.9)  # probabilities
NEG = f32(3, 4)
T01 = ints(3, 4, hi=2).astype(np.float32)
PM1 = (2 * ints(3, 4, hi=2) - 1).astype(np.float32)  # labels of +-1
LOGITS = f32(5, 6, lo=-2, hi=2)
LAB = np.array([0, 5, 2, 2, 3], np.int64)
LAB_IGN = np.array([0, -100, 2, 5, 1], np.int64)
SOFT = np.random.RandomState(3).dirichlet(np.ones(6), 5).astype(np.float32)
CW = f32(6, lo=0.5, hi=2.0)  # class weights
# [N, C, d]: cross entropy over axis 1
LOGITS3 = f32(4, 6, 3, lo=-2, hi=2)
LAB3 = ints(4, 3, hi=6)
SOFT3 = np.random.RandomState(5).dirichlet(np.ones(6), (4, 3)) \
    .transpose(0, 2, 1).astype(np.float32)
# integer-valued floats: ties in every pooling window
TIES = np.random.RandomState(7).randint(0, 3, (2, 3, 6, 7)).astype(
    np.float32)
TIES3 = np.random.RandomState(8).randint(0, 3, (1, 2, 5, 4, 6)).astype(
    np.float32)
TIES1 = np.random.RandomState(9).randint(0, 3, (2, 3, 11)).astype(np.float32)


def _pool_ids(shape, out_shape):
    """Unique flat indices of a [N, C, *out] pool over a [N, C, *in]
    plane (one per 2-wide window along the last dim)."""
    rng = np.random.RandomState(11)
    n = int(np.prod(shape[2:]))
    k = int(np.prod(out_shape[2:]))
    rows = [np.sort(rng.choice(n, k, replace=False))
            for _ in range(shape[0] * shape[1])]
    return np.stack(rows).reshape(out_shape).astype(np.int64)


# CTC: log-probabilities [T, B, C]
_LP = f32(12, 3, 5, lo=-3, hi=0)
CTC_LP = (_LP - np.log(np.exp(_LP).sum(-1, keepdims=True))).astype(
    np.float32)
CTC_LAB = np.array([[1, 2, 2, 0], [3, 1, 0, 0], [4, 4, 4, 1]], np.int64)
CTC_IN = np.array([12, 9, 11], np.int64)
CTC_LEN = np.array([3, 2, 4], np.int64)
# RNN-T: logits [B, T, U + 1, C], labels [B, U]
RNNT_X = f32(2, 5, 4, 6, lo=-2, hi=2)
RNNT_LAB = np.array([[1, 2, 3], [4, 5, 0]], np.int64)
RNNT_IN = np.array([5, 4], np.int64)
RNNT_LEN = np.array([3, 2], np.int64)
# beam search: ids and parents [T, B, K]
GT_IDS = ints(4, 2, 3, hi=20)
GT_PAR = ints(4, 2, 3, hi=3)
# sparse attention: [B, H, T, D] and a CSR pattern per (b, h)
SA_Q, SA_K, SA_V = f32(1, 2, 4, 8), f32(1, 2, 4, 8), f32(1, 2, 4, 8)
SA_OFF = np.array([[[0, 2, 3, 5, 7], [0, 1, 3, 4, 6]]], np.int64)
SA_COLS = np.array([[[0, 1, 1, 0, 2, 2, 3], [0, 0, 1, 2, 1, 3, 0]]],
                   np.int64)
SA_KP = np.array([[1, 1, 1, 0]], np.float32)
SA_AM = f32(4, 4, lo=-0.5, hi=0.5)
# attention [b, s, h, d]
FA_Q, FA_K, FA_V = f32(2, 24, 2, 16), f32(2, 24, 2, 16), f32(2, 24, 2, 16)
# hierarchical sigmoid: 7 classes, features of 5
HS_X, HS_W, HS_B = f32(4, 5), f32(6, 5), f32(6, 1)
HS_LAB = np.array([0, 3, 6, 4], np.int64)
HS_TABLE = np.array([[0, 1, -1], [0, 2, 4], [1, 3, -1], [0, 2, 5]],
                    np.int64)
HS_CODE = np.array([[1, 0, 0], [0, 1, 1], [1, 1, 0], [0, 0, 1]],
                   np.float32)


def _edit_rows():
    hyp = np.array([[1, 2, 3, 4, 0], [4, 5, 7, 7, 7], [2, 2, 2, 0, 0]],
                   np.int64)
    ref = np.array([[1, 3, 3, 0], [4, 5, 6, 1], [9, 9, 0, 0]], np.int64)
    return hyp, ref


ED_HYP, ED_REF = _edit_rows()
ED_HL = np.array([4, 5, 3], np.int64)
ED_RL = np.array([3, 4, 0], np.int64)


def _dist_l1(a, b):
    return (a - b).abs().sum(-1)


ROWS = [
    # -- activation -----------------------------------------------------------
    Row("tanh", lambda F, a: F.tanh(a, name="t"), (X,), (0,)),
    Row("celu", lambda F, a: F.celu(a, 0.5), (X,), (0,)),
    Row("elu", lambda F, a: F.elu(a, 0.7), (X,), (0,)),
    Row("elu_", lambda F, a: F.elu_(a, 0.7), (X,)),
    Row("gelu_tanh", lambda F, a: F.gelu(a, True, name="g"), (X,), (0,)),
    Row("glu", lambda F, a: F.glu(a), (X,), (0,)),
    Row("glu_axis1", lambda F, a: F.glu(a, axis=1), (X4,), (0,)),
    Row("hardshrink", lambda F, a: F.hardshrink(a, 0.3), (XNZ,), (0,)),
    Row("hardsigmoid", lambda F, a: F.hardsigmoid(a), (X * 4,), (0,)),
    Row("hardsigmoid_slope", lambda F, a: F.hardsigmoid(a, 0.2, 0.4),
        (X * 4,), (0,)),
    Row("hardswish", lambda F, a: F.hardswish(a), (X * 4,), (0,)),
    Row("hardtanh", lambda F, a: F.hardtanh(a, -0.5, 0.3), (XNZ,), (0,)),
    Row("hardtanh_", lambda F, a: F.hardtanh_(a, -0.5, 0.3), (XNZ,)),
    Row("leaky_relu_", lambda F, a: F.leaky_relu_(a, 0.2), (XNZ,)),
    Row("log_sigmoid", lambda F, a: F.log_sigmoid(a), (X * 3,), (0,)),
    Row("log_softmax", lambda F, a: F.log_softmax(a, axis=0), (X,), (0,)),
    Row("log_softmax_dtype", lambda F, a: F.log_softmax(a, dtype="float32"),
        (X,), (0,)),
    Row("maxout", lambda F, a: F.maxout(a, 2), (X4,), (0,)),
    Row("maxout_last", lambda F, a: F.maxout(a, 3, axis=-1), (X4,), (0,)),
    Row("mish", lambda F, a: F.mish(a), (X * 3,), (0,)),
    Row("prelu_scalar", lambda F, a, w: F.prelu(a, w), (XNZ, f32(1)),
        (0, 1)),
    Row("prelu_nchw", lambda F, a, w: F.prelu(a, w), (X4, f32(4)), (0, 1)),
    Row("prelu_nhwc", lambda F, a, w: F.prelu(a, w, data_format="NHWC"),
        (X4, f32(6)), (0, 1)),
    Row("relu_", lambda F, a: F.relu_(a), (X,)),
    Row("rrelu_eval", lambda F, a: F.rrelu(a, 0.1, 0.3, training=False),
        (X,), (0,)),
    Row("selu", lambda F, a: F.selu(a, 1.5, 2.0), (XNZ,), (0,)),
    Row("silu_name", lambda F, a: F.silu(a, name="s"), (X,), (0,)),
    Row("softmax_", lambda F, a: F.softmax_(a, axis=0), (X,)),
    Row("softmax_dtype", lambda F, a: F.softmax(a, 1, "float32", name="s"),
        (X,), (0,)),
    Row("softplus", lambda F, a: F.softplus(a, 2.0, 1.0), (X * 2,), (0,)),
    Row("softshrink", lambda F, a: F.softshrink(a, 0.3), (XNZ,), (0,)),
    Row("softsign", lambda F, a: F.softsign(a), (X,), (0,)),
    Row("swish", lambda F, a: F.swish(a), (X,), (0,)),
    Row("tanh_", lambda F, a: F.tanh_(a), (X,)),
    Row("tanhshrink", lambda F, a: F.tanhshrink(a), (X,), (0,)),
    Row("thresholded_relu", lambda F, a: F.thresholded_relu(a, 0.4),
        (XNZ,), (0,)),
    Row("thresholded_relu_", lambda F, a: F.thresholded_relu_(a, 0.4),
        (XNZ,)),
    Row("apply", lambda F, a, b: F.apply("add", lambda u, v: u * 2 + v,
                                         (a, b)), (X, P), (0, 1)),
    # -- common ---------------------------------------------------------------
    Row("linear_name", lambda F, a, w: F.linear(a, w, name="l"),
        (X, f32(4, 2)), (0, 1)),
    Row("dropout_eval", lambda F, a: F.dropout(a, 0.4, None, False), (X,),
        (0,)),
    Row("dropout_downscale_eval", lambda F, a: F.dropout(
        a, 0.4, training=False, mode="downscale_in_infer"), (X,), (0,)),
    Row("dropout_p0", lambda F, a: F.dropout(a, 0.0, axis=1), (X,), (0,)),
    Row("dropout2d_eval", lambda F, a: F.dropout2d(a, 0.5, False), (X4,)),
    Row("dropout3d_eval", lambda F, a: F.dropout3d(a, 0.5, False), (X5,)),
    Row("alpha_dropout_eval", lambda F, a: F.alpha_dropout(a, 0.5, False),
        (X,)),
    Row("embedding", lambda F, i, w: F.embedding(i, w),
        (ints(2, 3, hi=6), f32(6, 4)), (1,)),
    Row("embedding_padding", lambda F, i, w: F.embedding(i, w, 2),
        (np.array([[2, 0, 2], [5, 1, 2]], np.int64), f32(6, 4)), (1,)),
    Row("embedding_padding_neg", lambda F, i, w: F.embedding(
        i, w, padding_idx=-1), (np.array([5, 0, 5, 3], np.int64),
                                f32(6, 4)), (1,)),
    Row("one_hot", lambda F, i: F.one_hot(i, 4),
        (np.array([[0, 3], [4, 1]], np.int64),)),
    Row("label_smooth", lambda F, a: F.label_smooth(a, epsilon=0.2),
        (np.eye(4, dtype=np.float32),), (0,)),
    Row("label_smooth_prior", lambda F, a, p: F.label_smooth(a, p, 0.3),
        (np.eye(4, dtype=np.float32), f32(1, 4, lo=0, hi=0.5)), (0, 1)),
    Row("pad_constant_3d", lambda F, a: F.pad(a, [1, 2], value=0.5,
                                              data_format="NCL"),
        (X3,), (0,)),
    Row("pad_reflect_3d", lambda F, a: F.pad(a, [2, 3], "reflect",
                                             data_format="NCL"), (X3,),
        (0,)),
    Row("pad_replicate_3d", lambda F, a: F.pad(a, [2, 1], "replicate",
                                               data_format="NCL"), (X3,),
        (0,)),
    Row("pad_circular_3d", lambda F, a: F.pad(a, [3, 2], "circular",
                                              data_format="NCL"), (X3,),
        (0,)),
    Row("pad_constant_4d", lambda F, a: F.pad(a, [1, 0, 2, 1], value=-1.0),
        (X4,), (0,)),
    Row("pad_reflect_4d", lambda F, a: F.pad(a, [2, 1, 3, 2], "reflect"),
        (X4,), (0,)),
    Row("pad_replicate_4d", lambda F, a: F.pad(a, [1, 2, 0, 3],
                                               "replicate"), (X4,), (0,)),
    Row("pad_circular_4d", lambda F, a: F.pad(a, [2, 2, 1, 3], "circular"),
        (X4,), (0,)),
    Row("pad_reflect_4d_nhwc", lambda F, a: F.pad(a, [1, 2, 2, 1], "reflect",
                                                  data_format="NHWC"),
        (X4,), (0,)),
    Row("pad_constant_5d", lambda F, a: F.pad(a, [1, 1, 0, 2, 2, 0],
                                              value=2.0,
                                              data_format="NCDHW"),
        (X5,), (0,)),
    Row("pad_reflect_5d", lambda F, a: F.pad(a, [1, 2, 2, 1, 1, 1],
                                             "reflect",
                                             data_format="NCDHW"), (X5,),
        (0,)),
    Row("pad_replicate_5d", lambda F, a: F.pad(a, [2, 0, 1, 1, 0, 3],
                                               "replicate",
                                               data_format="NCDHW"),
        (X5,), (0,)),
    Row("pad_circular_5d", lambda F, a: F.pad(a, [1, 2, 3, 1, 2, 1],
                                              "circular",
                                              data_format="NCDHW"), (X5,),
        (0,)),
    Row("pad_every_dim", lambda F, a: F.pad(a, [1, 0, 0, 2], "replicate"),
        (X,), (0,)),
    Row("pad_reflect_twice", lambda F, a: F.pad(a, [9, 8], "reflect",
                                                data_format="NCL"), (X3,),
        (0,)),
    Row("zeropad2d", lambda F, a: F.zeropad2d(a, [1, 2, 0, 1]), (X4,), (0,)),
    Row("normalize", lambda F, a: F.normalize(a), (X,), (0,)),
    Row("normalize_p1", lambda F, a: F.normalize(a, p=1, axis=-1), (X4,),
        (0,)),
    Row("cosine_similarity", lambda F, a, b: F.cosine_similarity(a, b),
        (X, P), (0, 1)),
    Row("cosine_similarity_axis", lambda F, a, b: F.cosine_similarity(
        a, b, axis=-1), (X4, X4[::-1].copy()), (0, 1)),
    Row("pairwise_distance", lambda F, a, b: F.pairwise_distance(a, b),
        (X, P), (0, 1)),
    Row("pairwise_distance_p1", lambda F, a, b: F.pairwise_distance(
        a, b, 1.0, keepdim=True), (X, P), (0, 1)),
    Row("pixel_shuffle_nhwc", lambda F, a: F.pixel_shuffle(
        a, 2, "NHWC"), (f32(2, 3, 2, 8),), (0,)),
    Row("pixel_unshuffle", lambda F, a: F.pixel_unshuffle(a, 2),
        (f32(2, 3, 4, 6),), (0,)),
    Row("pixel_unshuffle_nhwc", lambda F, a: F.pixel_unshuffle(
        a, 2, "NHWC"), (f32(2, 4, 6, 3),), (0,)),
    Row("channel_shuffle_nhwc", lambda F, a: F.channel_shuffle(
        a, 3, "NHWC"), (f32(2, 3, 2, 6),), (0,)),
    Row("interp_nearest_scale", lambda F, a: F.interpolate(
        a, scale_factor=2), (X4,), (0,)),
    Row("interp_nearest_align", lambda F, a: F.interpolate(
        a, size=[7, 4], align_corners=True), (X4,), (0,)),
    Row("interp_nearest_scale_15", lambda F, a: F.interpolate(
        a, scale_factor=1.5), (X4,), (0,)),
    Row("interp_bilinear", lambda F, a: F.interpolate(
        a, size=[9, 4], mode="bilinear"), (X4,), (0,)),
    Row("interp_bilinear_align", lambda F, a: F.interpolate(
        a, scale_factor=[1.5, 2.5], mode="bilinear", align_corners=True),
        (X4,), (0,)),
    Row("interp_bilinear_mode1", lambda F, a: F.interpolate(
        a, size=[8, 11], mode="bilinear", align_mode=1), (X4,), (0,)),
    Row("interp_bicubic", lambda F, a: F.interpolate(
        a, size=[8, 9], mode="bicubic"), (X4,), (0,)),
    Row("interp_area", lambda F, a: F.interpolate(
        a, size=[3, 4], mode="area"), (X4,), (0,)),
    Row("interp_linear_ncw", lambda F, a: F.interpolate(
        a, size=[10], mode="linear", data_format="NCW"), (X3,), (0,)),
    Row("interp_trilinear", lambda F, a: F.interpolate(
        a, size=[5, 3, 6], mode="trilinear"), (X5,), (0,)),
    Row("interp_nhwc", lambda F, a: F.interpolate(
        a, size=[7, 3], mode="bilinear", data_format="NHWC"), (X4,), (0,)),
    Row("interp_int", lambda F, a: F.interpolate(
        a, scale_factor=2, mode="bilinear"), (ints(1, 2, 3, 3, hi=50),)),
    Row("interp_size_tensor", lambda F, a, s: F.interpolate(
        a, size=s, mode="bilinear"), (X4, np.array([6, 8], np.int64)),
        (0,)),
    Row("upsample", lambda F, a: F.upsample(a, scale_factor=2,
                                            mode="bilinear"), (X4,), (0,)),
    Row("unfold", lambda F, a: F.unfold(a, 2, 2, 1), (X4,), (0,)),
    Row("unfold_pads4_dilation", lambda F, a: F.unfold(
        a, [2, 3], 1, [1, 0, 2, 1], 2), (X4,), (0,)),
    Row("fold_stride_pad", lambda F, a: F.fold(a, [5, 6], 2, 2, 1),
        (f32(2, 12, 12),), (0,)),
    Row("bilinear", lambda F, a, b, w, c: F.bilinear(a, b, w, c),
        (X, f32(3, 5), f32(2, 4, 5), f32(1, 2)), (0, 1, 2, 3)),
    Row("grid_sample", lambda F, a, g: F.grid_sample(a, g),
        (X4, f32(2, 3, 5, 2, lo=-1.1, hi=1.1)), (0, 1)),
    Row("grid_sample_unaligned", lambda F, a, g: F.grid_sample(
        a, g, align_corners=False), (X4, f32(2, 3, 5, 2, lo=-1.1, hi=1.1)),
        (0, 1)),
    Row("affine_grid_unaligned", lambda F, t: F.affine_grid(
        t, [2, 1, 3, 5], align_corners=False), (f32(2, 2, 3),), (0,)),
    Row("sequence_mask", lambda F, i: F.sequence_mask(i),
        (np.array([2, 0, 5, 3], np.int64),)),
    Row("sequence_mask_maxlen", lambda F, i: F.sequence_mask(
        i, maxlen=6, dtype="float32"), (np.array([[2, 4], [1, 6]],
                                                 np.int64),)),
    Row("gather_tree", lambda F, i, p: F.gather_tree(i, p),
        (GT_IDS, GT_PAR)),
    Row("temporal_shift", lambda F, a: F.temporal_shift(a, 2, 0.3),
        (f32(4, 6, 2, 3),), (0,)),
    Row("temporal_shift_nhwc", lambda F, a: F.temporal_shift(
        a, 3, data_format="NHWC"), (f32(6, 2, 3, 8),), (0,)),
    Row("diag_embed", lambda F, a: F.diag_embed(a, 1), (X,), (0,)),
    Row("sparse_attention", lambda F, q, k, v, o, c: F.sparse_attention(
        q, k, v, o, c), (SA_Q, SA_K, SA_V, SA_OFF, SA_COLS), (0, 1, 2)),
    Row("sparse_attention_masks", lambda F, q, k, v, o, c, kp, am:
        F.sparse_attention(q, k, v, o, c, key_padding_mask=kp,
                           attn_mask=am),
        (SA_Q, SA_K, SA_V, SA_OFF, SA_COLS, SA_KP, SA_AM), (0, 1, 2)),
    # -- loss -----------------------------------------------------------------
    Row("ce_weight", lambda F, x, y, w: F.cross_entropy(x, y, w),
        (LOGITS, LAB, CW), (0,)),
    Row("ce_weight_ignore", lambda F, x, y, w: F.cross_entropy(
        x, y, weight=w, ignore_index=-100), (LOGITS, LAB_IGN, CW), (0,)),
    Row("ce_ignore_none", lambda F, x, y: F.cross_entropy(
        x, y, reduction="none"), (LOGITS, LAB_IGN), (0,)),
    Row("ce_sum", lambda F, x, y: F.cross_entropy(x, y, reduction="sum"),
        (LOGITS, LAB), (0,)),
    Row("ce_label_column", lambda F, x, y: F.cross_entropy(x, y),
        (LOGITS, LAB[:, None]), (0,)),
    Row("ce_soft", lambda F, x, y: F.cross_entropy(x, y, soft_label=True),
        (LOGITS, SOFT), (0, 1)),
    Row("ce_soft_axis1", lambda F, x, y: F.cross_entropy(
        x, y, soft_label=True, axis=1, reduction="none"), (LOGITS3, SOFT3),
        (0, 1)),
    Row("ce_axis1", lambda F, x, y: F.cross_entropy(x, y, axis=1),
        (LOGITS3, LAB3), (0,)),
    Row("ce_no_softmax", lambda F, x, y: F.cross_entropy(
        x, y, use_softmax=False), (SOFT, LAB), (0,)),
    Row("ce_smoothing", lambda F, x, y, w: F.cross_entropy(
        x, y, w, label_smoothing=0.1), (LOGITS, LAB_IGN, CW), (0,)),
    Row("ce_smoothing_soft", lambda F, x, y: F.cross_entropy(
        x, y, soft_label=True, label_smoothing=0.2, reduction="sum"),
        (LOGITS, SOFT), (0,)),
    Row("softmax_with_ce", lambda F, x, y: F.softmax_with_cross_entropy(
        x, y, return_softmax=True), (LOGITS, LAB[:, None]), (0,)),
    Row("softmax_with_ce_soft_axis", lambda F, x, y:
        F.softmax_with_cross_entropy(x, y, soft_label=True, axis=1),
        (LOGITS3, SOFT3), (0,)),
    Row("nll_loss_weight", lambda F, x, y, w: F.nll_loss(x, y, w),
        (LOGITS, LAB_IGN, CW), (0,)),
    Row("nll_loss_sum", lambda F, x, y: F.nll_loss(x, y, reduction="sum"),
        (LOGITS, LAB), (0,)),
    Row("nll_loss_nd_none", lambda F, x, y: F.nll_loss(x, y,
                                                       reduction="none"),
        (LOGITS3, LAB3), (0,)),
    Row("mse_loss_sum", lambda F, a, b: F.mse_loss(a, b, "sum"), (X, P),
        (0, 1)),
    Row("l1_loss_none", lambda F, a, b: F.l1_loss(a, b, "none"), (X, P),
        (0, 1)),
    Row("smooth_l1_loss", lambda F, a, b: F.smooth_l1_loss(
        a, b, delta=0.5), (X * 2, P), (0, 1)),
    Row("bce_weight", lambda F, p, t, w: F.binary_cross_entropy(
        p, t, w, "sum"), (P, T01, f32(4, lo=0.5, hi=1.5)), (0,)),
    Row("bce_logits", lambda F, z, t: F.binary_cross_entropy_with_logits(
        z, t), (X * 3, T01), (0,)),
    Row("bce_logits_weights", lambda F, z, t, w, pw:
        F.binary_cross_entropy_with_logits(z, t, w, "none", pw),
        (X * 3, T01, f32(4, lo=0.5, hi=1.5), f32(4, lo=0.5, hi=3)), (0,)),
    Row("bce_logits_pos_weight", lambda F, z, t, pw:
        F.binary_cross_entropy_with_logits(z, t, pos_weight=pw),
        (X * 3, T01, f32(4, lo=0.5, hi=3)), (0,)),
    Row("kl_div_batchmean", lambda F, a, b: F.kl_div(a, b, "batchmean"),
        (X, P), (0,)),
    Row("kl_div_log_target", lambda F, a, b: F.kl_div(
        a, b, "none", log_target=True), (X, X[::-1].copy()), (0, 1)),
    Row("kl_div_zero_target", lambda F, a, b: F.kl_div(a, b, "sum"),
        (X, T01 * P), (0,)),
    Row("margin_ranking_loss", lambda F, a, b, t: F.margin_ranking_loss(
        a, b, t, 0.2), (X, P, PM1), (0, 1)),
    Row("hinge_embedding_loss", lambda F, a, t: F.hinge_embedding_loss(
        a, t, 0.5, "sum"), (X, PM1), (0,)),
    Row("cosine_embedding_loss", lambda F, a, b, t: F.cosine_embedding_loss(
        a, b, t, 0.1), (X, P, PM1[:, 0]), (0, 1)),
    Row("triplet_margin_loss", lambda F, a, p, n: F.triplet_margin_loss(
        a, p, n), (X, P, NEG), (0, 1, 2)),
    Row("triplet_margin_loss_swap_p1", lambda F, a, p, n:
        F.triplet_margin_loss(a, p, n, 0.5, 1.0, swap=True,
                              reduction="none"),
        (X, P, NEG), (0, 1, 2)),
    Row("multi_label_soft_margin_loss", lambda F, z, t, w:
        F.multi_label_soft_margin_loss(z, t, w), (X * 2, T01,
                                                  f32(4, lo=0.5, hi=1.5)),
        (0,)),
    Row("soft_margin_loss", lambda F, z, t: F.soft_margin_loss(z, t, "sum"),
        (X * 2, PM1), (0,)),
    Row("square_error_cost", lambda F, a, b: F.square_error_cost(a, b),
        (X, P), (0, 1)),
    Row("log_loss", lambda F, p, t: F.log_loss(p, t), (P, T01), (0,)),
    # the CTC and RNN-T rows: T steps of logaddexp whose roundings the card
    # takes in another order (card_tol 1e-4)
    Row("ctc_loss_mean", lambda F, lp, y, il, ll: F.ctc_loss(
        lp, y, il, ll), (CTC_LP, CTC_LAB, CTC_IN, CTC_LEN), (0,), 1e-5, 1e-4),
    Row("ctc_loss_none_blank", lambda F, lp, y, il, ll: F.ctc_loss(
        lp, y, il, ll, blank=4, reduction="none", norm_by_times=True),
        (CTC_LP, CTC_LAB % 4, CTC_IN, CTC_LEN), (0,), 1e-5, 1e-4),
    Row("ctc_loss_sum", lambda F, lp, y, il, ll: F.ctc_loss(
        lp, y, il, ll, reduction="sum"), (CTC_LP, CTC_LAB, CTC_IN, CTC_LEN),
        (0,), 1e-5, 1e-4),
    Row("sigmoid_focal_loss", lambda F, z, t, n: F.sigmoid_focal_loss(
        z, t, n), (X * 2, T01, np.array([3.0], np.float32)), (0,)),
    Row("sigmoid_focal_loss_mean", lambda F, z, t: F.sigmoid_focal_loss(
        z, t, alpha=0.4, gamma=1.5, reduction="mean"), (X * 2, T01), (0,)),
    Row("huber_loss", lambda F, a, b: F.huber_loss(a, b, 0.6, "none"),
        (X * 2, P), (0, 1)),
    Row("edit_distance", lambda F, h, r: F.edit_distance(h, r), (ED_HYP,
                                                               ED_REF)),
    Row("edit_distance_lengths", lambda F, h, r, hl, rl: F.edit_distance(
        h, r, False, input_length=hl, label_length=rl),
        (ED_HYP, ED_REF, ED_HL, ED_RL)),
    Row("edit_distance_ignored", lambda F, h, r: F.edit_distance(
        h, r, ignored_tokens=[0, 7]), (ED_HYP, ED_REF)),
    Row("hsigmoid_loss", lambda F, x, y, w, b: F.hsigmoid_loss(
        x, y, 7, w, b), (HS_X, HS_LAB, HS_W, HS_B), (0, 2, 3)),
    Row("hsigmoid_loss_custom", lambda F, x, y, w, pt_, pc:
        F.hsigmoid_loss(x, y, 7, w, path_table=pt_, path_code=pc),
        (HS_X, HS_LAB, HS_W, HS_TABLE, HS_CODE), (0, 2)),
    Row("poisson_nll_loss", lambda F, a, b: F.poisson_nll_loss(a, b),
        (X, P * 3), (0,)),
    Row("poisson_nll_loss_full", lambda F, a, b: F.poisson_nll_loss(
        a, b, False, True, reduction="sum"), (P, P * 3), (0,)),
    Row("gaussian_nll_loss", lambda F, a, b, v: F.gaussian_nll_loss(
        a, b, v, True), (X, P, P * 2), (0, 2)),
    Row("multi_margin_loss", lambda F, x, y, w: F.multi_margin_loss(
        x, y, 2, 0.8, w), (LOGITS, LAB, CW), (0,)),
    Row("triplet_distance_default", lambda F, a, p, n:
        F.triplet_margin_with_distance_loss(a, p, n, swap=True),
        (X, P, NEG), (0, 1, 2)),
    Row("triplet_distance_custom", lambda F, a, p, n:
        F.triplet_margin_with_distance_loss(a, p, n, _dist_l1, 0.5,
                                            reduction="none"),
        (X, P, NEG), (0, 1, 2)),
    Row("dice_loss", lambda F, x, y: F.dice_loss(x, y),
        (SOFT.reshape(5, 1, 6), ints(5, 1, 1, hi=6)), (0,)),
    Row("npair_loss", lambda F, a, p, y: F.npair_loss(a, p, y),
        (X, P, np.array([1, 2, 1], np.int64)), (0, 1)),
    Row("rnnt_loss", lambda F, x, y, il, ll: F.rnnt_loss(x, y, il, ll),
        (RNNT_X, RNNT_LAB, RNNT_IN, RNNT_LEN), (0,), 1e-5, 1e-4),
    Row("rnnt_loss_plain_none", lambda F, x, y, il, ll: F.rnnt_loss(
        x, y, il, ll, blank=0, fastemit_lambda=0.0, reduction="none"),
        (RNNT_X, RNNT_LAB, RNNT_IN, RNNT_LEN), (0,), 1e-5, 1e-4),
    Row("chunked_ce", lambda F, h, w, y: F.chunked_softmax_cross_entropy(
        h, w, y, 4, name="c"), (f32(3, 5), f32(5, 10), np.array(
            [1, 9, 12], np.int64)), (0, 1)),
    Row("margin_cross_entropy", lambda F, x, y: F.margin_cross_entropy(
        x, y, return_softmax=True, reduction="none"),
        (LOGITS / 2.5, LAB), (0,)),
    Row("margin_cross_entropy_sum", lambda F, x, y: F.margin_cross_entropy(
        x, y, 0.9, 0.3, 0.1, 16.0, reduction="sum"), (LOGITS / 2.5, LAB),
        (0,)),
    # -- pooling --------------------------------------------------------------
    Row("max_pool1d_mask", lambda F, a: F.max_pool1d(
        a, 3, 2, 1, return_mask=True), (TIES1,), (0,)),
    Row("max_pool2d_mask", lambda F, a: F.max_pool2d(
        a, 2, return_mask=True), (TIES,), (0,)),
    Row("max_pool2d_mask_pad_ceil", lambda F, a: F.max_pool2d(
        a, 3, 2, 1, return_mask=True, ceil_mode=True), (TIES,), (0,)),
    Row("max_pool2d_mask_x", lambda F, a: F.max_pool2d(
        a, [2, 3], [1, 2], return_mask=True), (X4,), (0,)),
    Row("max_pool3d_mask", lambda F, a: F.max_pool3d(
        a, 2, 1, return_mask=True), (TIES3,), (0,)),
    Row("adaptive_max_pool1d", lambda F, a: F.adaptive_max_pool1d(a, 4),
        (X3,), (0,)),
    Row("adaptive_max_pool3d", lambda F, a: F.adaptive_max_pool3d(
        a, [2, 3, 2]), (X5,), (0,)),
    Row("avg_pool1d", lambda F, a: F.avg_pool1d(a, 3, 2, 1), (X3,), (0,)),
    Row("adaptive_avg_pool1d", lambda F, a: F.adaptive_avg_pool1d(a, 3),
        (X3,), (0,)),
    Row("adaptive_avg_pool2d_nhwc", lambda F, a: F.adaptive_avg_pool2d(
        a, [3, 4], "NHWC"), (X4,), (0,)),
    Row("adaptive_avg_pool3d", lambda F, a: F.adaptive_avg_pool3d(a, 2),
        (X5,), (0,)),
    Row("adaptive_max_pool2d", lambda F, a: F.adaptive_max_pool2d(
        a, [2, 4]), (X4,), (0,)),
    Row("lp_pool2d", lambda F, a: F.lp_pool2d(a, 2, 2), (X4,), (0,)),
    Row("lp_pool2d_p3_ceil_nhwc", lambda F, a: F.lp_pool2d(
        a, 3, 3, 2, 1, True, "NHWC"), (X4,), (0,)),
    Row("max_unpool1d", lambda F, a, i: F.max_unpool1d(a, i, 2),
        (f32(2, 3, 4), _pool_ids((2, 3, 8), (2, 3, 4))), (0,)),
    Row("max_unpool2d_size", lambda F, a, i: F.max_unpool2d(
        a, i, 2, output_size=[5, 7]), (f32(1, 2, 2, 3),
                                       _pool_ids((1, 2, 5, 7), (1, 2, 2, 3))),
        (0,)),
    Row("max_unpool3d", lambda F, a, i: F.max_unpool3d(a, i, 2),
        (f32(1, 2, 2, 1, 2), _pool_ids((1, 2, 4, 2, 4), (1, 2, 2, 1, 2))),
        (0,)),
    # -- conv -----------------------------------------------------------------
    Row("conv1d", lambda F, a, w: F.conv1d(a, w, padding=1, groups=3),
        (X3, f32(6, 1, 3)), (0, 1), 1e-5, 1e-4),
    Row("conv1d_transpose", lambda F, a, w, b: F.conv1d_transpose(
        a, w, b, stride=2, padding=1, output_padding=1), (X3, f32(3, 4, 3),
                                                          f32(4)),
        (0, 1, 2), 1e-5, 1e-4),  # cuDNN's sums
    Row("conv1d_transpose_nlc", lambda F, a, w: F.conv1d_transpose(
        a, w, dilation=2, data_format="NLC"), (f32(2, 7, 3), f32(3, 2, 3)),
        (0, 1), 1e-5, 1e-4),
    Row("conv2d_transpose_groups", lambda F, a, w: F.conv2d_transpose(
        a, w, stride=2, padding=1, groups=2, dilation=2),
        (X4, f32(4, 3, 3, 2)), (0, 1), 1e-5, 1e-4),
    Row("conv2d_transpose_output_size", lambda F, a, w, b:
        F.conv2d_transpose(a, w, b, stride=2, padding=[1, 0],
                           output_size=[10, 12]),
        (X4, f32(4, 2, 3, 2), f32(2)), (0, 1, 2), 1e-5, 1e-4),
    Row("conv2d_transpose_nhwc", lambda F, a, w: F.conv2d_transpose(
        a, w, stride=[1, 2], output_padding=[0, 1], data_format="NHWC"),
        (f32(2, 4, 5, 3), f32(3, 2, 2, 3)), (0, 1), 1e-5, 1e-4),
    Row("conv3d_transpose", lambda F, a, w, b: F.conv3d_transpose(
        a, w, b, stride=2, padding=1), (f32(1, 2, 3, 4, 3), f32(2, 3, 3, 2, 2),
                                        f32(3)), (0, 1, 2), 1e-5, 1e-4),
    Row("conv3d_transpose_ndhwc", lambda F, a, w: F.conv3d_transpose(
        a, w, groups=2, data_format="NDHWC"),
        (f32(1, 3, 2, 3, 4), f32(4, 1, 2, 2, 2)), (0, 1), 1e-5, 1e-4),
    # -- norm -----------------------------------------------------------------
    Row("group_norm", lambda F, a, w, b: F.group_norm(a, 2, w, b), (
        X4, f32(4, lo=0.5, hi=1.5), f32(4)), (0, 1, 2)),
    Row("group_norm_nhwc_plain", lambda F, a: F.group_norm(
        a, 3, epsilon=1e-3, data_format="NHWC"), (X4,), (0,)),
    Row("instance_norm", lambda F, a, w, b: F.instance_norm(
        a, weight=w, bias=b), (X4, f32(4, lo=0.5, hi=1.5), f32(4)),
        (0, 1, 2)),
    Row("instance_norm_running", lambda F, a, m, v: F.instance_norm(
        a, m, v, use_input_stats=False), (X4, f32(4), f32(4, lo=0.5, hi=2)),
        (0,)),
    Row("instance_norm_ndhwc", lambda F, a: F.instance_norm(
        a, eps=1e-3, data_format="NDHWC"), (X5,), (0,)),
    # the reference's reduce_window has no reverse-mode rule here: values
    # only (the port's gradient is autograd's through its sums)
    Row("local_response_norm", lambda F, a: F.local_response_norm(
        a, 3, 0.1, 0.75, 2.0), (X4,)),
    Row("local_response_norm_even_nhwc", lambda F, a: F.local_response_norm(
        a, 4, 0.2, 0.5, data_format="NHWC"), (X4,)),
    # -- attention ------------------------------------------------------------
    Row("flash_attention", lambda F, q, k, v: F.flash_attention(q, k, v),
        (FA_Q, FA_K, FA_V), (0, 1, 2)),
    Row("flash_attention_causal", lambda F, q, k, v: F.flash_attention(
        q, k, v, causal=True, return_softmax=True), (FA_Q, FA_K, FA_V),
        (0, 1, 2)),
    Row("ring_degree1", lambda F, q, k, v: F.ring_flash_attention(q, k, v),
        (FA_Q, FA_K, FA_V), (0, 1, 2)),
    Row("ulysses_degree1", lambda F, q, k, v: F.ulysses_attention(
        q, k, v, causal=False), (FA_Q, FA_K, FA_V), (0, 1, 2)),
    Row("sdpa_name", lambda F, q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, name="a"), (FA_Q, FA_K, FA_V), (0, 1, 2)),
    Row("sliding_window_name", lambda F, q, k, v: F.sliding_window_attention(
        q, k, v, 5, name="w"), (FA_Q, FA_K, FA_V), (0, 1, 2)),
]


def flat(out):
    """A call's outputs as a flat list (nested tuples and lists opened)."""
    if isinstance(out, (tuple, list)):
        return [o for x in out for o in flat(x)]
    return [out]


def cotangents(shapes, seed=19):
    """One seeded numpy cotangent per float output shape."""
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1, 1, tuple(s)).astype(np.float32) for s in shapes]


def _is_float(a):
    return np.asarray(a).dtype.kind == "f"


def port_grads(call, inputs, grad, device="cpu"):
    """The port's gradients of ``sum(out * cotangent)`` over the float
    outputs of ``call(*inputs)`` with respect to the inputs ``grad``
    (zeros where an input does not reach them), as numpy."""
    import torch

    ts = [ptt.to_tensor(np.array(a), place=device) for a in inputs]
    for i in grad:
        ts[i].requires_grad_(True)
    outs = [o for o in flat(call(*ts)) if isinstance(o, torch.Tensor)
            and o.is_floating_point()]
    cots = cotangents([o.shape for o in outs])
    loss = sum((o * torch.from_numpy(c).to(o.device)).sum()
               for o, c in zip(outs, cots))
    got = torch.autograd.grad(loss, [ts[i] for i in grad],
                              allow_unused=True)
    return [np.zeros(np.shape(inputs[i]), np.float32) if g is None
            else g.detach().cpu().numpy() for i, g in zip(grad, got)]


def reference_grads(pt, call, inputs, grad):
    """:func:`port_grads` through the reference package ``pt`` (passed in:
    this module does not import it), by its ``backward()``."""
    ts = [pt.to_tensor(np.array(a), stop_gradient=i not in grad)
          if _is_float(a) else pt.to_tensor(np.array(a))
          for i, a in enumerate(inputs)]
    outs = [o for o in flat(call(*ts)) if isinstance(o, pt.Tensor)
            and np.asarray(o.numpy()).dtype.kind == "f"]
    cots = cotangents([o.shape for o in outs])
    loss = None
    for o, c in zip(outs, cots):
        term = (o * pt.to_tensor(c)).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    return [np.zeros(np.shape(inputs[i]), np.float32) if ts[i].grad is None
            else np.asarray(ts[i].grad.numpy()) for i in grad]


# -- the random functions -----------------------------------------------------

# every statistic is an average of many draws: 6 standard errors apart is
# a 2e-9 chance
SIGMAS = 6.0
RANDOM = ["dropout", "dropout2d", "dropout3d", "alpha_dropout", "rrelu",
          "gumbel_softmax", "class_center_sample"]

_SELU_AP = -1.6732632423543772 * 1.0507009873554805


def alpha_coefs(p):
    """The reference's fp32 coefficients of ``alpha_dropout``."""
    a = np.float32(1.0 / np.sqrt((1 - p) * (1 + p * _SELU_AP ** 2)))
    return float(a), float(-a * p * _SELU_AP)


def draw(F, name, dev="cpu"):
    """``(fn, samples, mean, se)``: a call that draws ``name`` from the
    package ``F`` on ``dev``, the function of its output whose values are
    the draws, and their expected mean and its standard error."""
    import torch

    def full(shape, v):
        return torch.full(shape, v, device=dev)
    if name == "dropout":  # one draw a column
        p = 0.25
        return (lambda: F.dropout(full((4, 20000), 1.0), p, axis=1),
                lambda o: o[0], 1.0, np.sqrt(p / (1 - p) / 20000))
    if name in ("dropout2d", "dropout3d"):
        p = 0.3 if name == "dropout2d" else 0.4
        shape = (1250, 16, 2, 2) if name == "dropout2d" \
            else (1250, 16, 2, 1, 2)
        fn = getattr(F, name)
        return (lambda: fn(full(shape, 1.0), p),
                lambda o: o.reshape(20000, -1)[:, 0], 1.0,
                np.sqrt(p / (1 - p) / 20000))
    if name == "alpha_dropout":
        p = 0.2
        a, b = alpha_coefs(p)
        return (lambda: F.alpha_dropout(full((20000,), 0.0), p),
                lambda o: o, b + p * a * _SELU_AP,
                np.sqrt(p * (1 - p) * (a * _SELU_AP) ** 2 / 20000))
    if name == "rrelu":
        return (lambda: F.rrelu(full((20000,), -1.0), 0.1, 0.3),
                lambda o: -o, 0.2, np.sqrt(0.2 ** 2 / 12 / 20000))
    if name == "gumbel_softmax":  # sigmoid of a logistic: uniform
        return (lambda: F.gumbel_softmax(full((20000, 2), 0.0)),
                lambda o: o[:, 0], 0.5, np.sqrt(1 / 12 / 20000))
    if name == "class_center_sample":
        pos = np.arange(0, 100, 10)
        neg = np.setdiff1d(np.arange(10000), pos)
        n = 2000
        fpc = (neg.size - n) / (neg.size - 1)
        label = torch.from_numpy(pos).to(dev)

        def negatives(out):
            s = out[1]
            return s[~torch.isin(s, label.to(s.dtype))]
        return (lambda: F.class_center_sample(label, 10000, n + pos.size),
                negatives, float(neg.mean()),
                float(np.sqrt(neg.var() / n * fpc)))
    raise KeyError(name)


# -- the op specs in the functional namespace ---------------------------------


def functional_specs(specs):
    """The names of the specs of ``tests/op_specs.py`` whose callable lies
    in ``paddle_tpu.nn.functional``."""
    return sorted(n for n, s in specs.items()
                  if s["path"].startswith("paddle_tpu.nn.functional."))


def cpu_tensor(a):
    return ptt.to_tensor(np.array(a), place="cpu")


@functools.cache
def covered():
    """The names of the ``nn.functional`` functions that the rows and the
    random draws call, as a recorder of the port sees them on the
    CPU."""
    rec = Recorder(TF)
    with using_device("cpu"):
        for row in ROWS:
            row.call(rec, *[cpu_tensor(a) for a in row.inputs])
        for name in RANDOM:
            draw(rec, name)[0]()
    return frozenset(name for name, _ in rec.seen)
