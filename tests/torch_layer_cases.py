"""The table of the port's nn layer tests, free of JAX.

``tests/test_torch_layer_sweep.py`` runs each case against the reference
on the CPU; ``chip_smoke.py`` phase 25d runs them on the card against the
port's own CPU results. A case is ``Case(id, build, inputs, grad, train,
call, tol, card_tol)``: ``build(nn, T)`` makes the layer from either
package's ``nn`` (``T`` makes that package's tensor of a numpy array, for
a layer that takes one, such as a loss's class weights); the layer is put
in training mode (``train``) or eval mode and called as ``call(layer,
*xs)`` (default ``layer(*xs)``) on the numpy ``inputs`` made tensors;
``grad`` names the inputs whose gradient is held beside every
parameter's (of ``sum(out * cotangent)`` over the float outputs, the
cotangents of ``torch_functional_cases.cotangents``; None: outputs only,
where the reference has no gradient); ``tol`` bounds the
distance from the reference relative to the largest magnitude, and
``card_tol`` the card's from the CPU. The reference's layer's
``state_dict()`` is carried into the port's layer by name
(``load_jax_weights``) before the call, so the two compute the same
function. The specs of ``tests/test_layer_sweep.py`` come first, under
its names; the rest cover the layers that sweep leaves out.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from torch_functional_cases import (
    CTC_IN, CTC_LAB, CTC_LEN, CTC_LP, CW, HS_LAB, HS_X, LAB, LOGITS, NEG, P,
    PM1, RNNT_IN, RNNT_LAB, RNNT_LEN, RNNT_X, T01, X, _pool_ids, cotangents,
    f32, flat,
)

CARD_TOL = 1e-5
# arrays a build function takes, drawn once (both packages get the same)
PW = f32(4, lo=0.5, hi=3)
X6 = f32(2, 6)


class Case(NamedTuple):
    id: str
    build: object
    inputs: tuple
    grad: tuple = (0,)
    train: bool = True
    call: object = None
    tol: float = 1e-5
    card_tol: float = CARD_TOL


def _x(*shape):
    """The sweep's inputs: N(0, 1) from a seed of the shape."""
    rng = np.random.RandomState(hash(shape) % (2 ** 31))
    return rng.randn(*shape).astype(np.float32)


# tests/test_layer_sweep.py's families
ACTIVATIONS = [
    "ReLU", "ReLU6", "Sigmoid", "LogSigmoid", "Tanh", "Tanhshrink",
    "GELU", "SiLU", "Silu", "Swish", "Mish", "LeakyReLU", "ELU", "SELU",
    "CELU", "Hardtanh", "Hardshrink", "Softshrink", "Hardsigmoid",
    "Hardswish", "Softplus", "Softsign", "Softmax", "LogSoftmax",
    "ThresholdedReLU",
]

CASES = [Case(f"activation_{n}", lambda nn, T, n=n: getattr(nn, n)(),
              (_x(2, 6),)) for n in ACTIVATIONS]
CASES += [
    Case("PReLU", lambda nn, T: nn.PReLU(), (_x(2, 4),)),
    Case("Maxout", lambda nn, T: nn.Maxout(groups=2), (_x(2, 4, 3, 3),)),
    Case("GLU", lambda nn, T: nn.GLU(), (_x(2, 8),)),
    Case("RReLU_eval", lambda nn, T: nn.RReLU(), (_x(2, 4),), train=False),
    Case("Softmax2D", lambda nn, T: nn.Softmax2D(), (_x(2, 3, 4, 4),)),
]
_NORMS = [
    ("BatchNorm", lambda nn, T: nn.BatchNorm(4), (2, 4, 8)),
    ("BatchNorm1D", lambda nn, T: nn.BatchNorm1D(4), (2, 4, 8)),
    ("BatchNorm2D", lambda nn, T: nn.BatchNorm2D(4), (2, 4, 6, 6)),
    ("BatchNorm3D", lambda nn, T: nn.BatchNorm3D(4), (2, 4, 3, 3, 3)),
    ("SyncBatchNorm", lambda nn, T: nn.SyncBatchNorm(4), (2, 4, 6, 6)),
    ("LayerNorm", lambda nn, T: nn.LayerNorm(8), (2, 5, 8)),
    ("RMSNorm", lambda nn, T: nn.RMSNorm(8), (2, 5, 8)),
    ("GroupNorm", lambda nn, T: nn.GroupNorm(2, 4), (2, 4, 6, 6)),
    ("InstanceNorm1D", lambda nn, T: nn.InstanceNorm1D(4), (2, 4, 8)),
    ("InstanceNorm2D", lambda nn, T: nn.InstanceNorm2D(4), (2, 4, 6, 6)),
    ("InstanceNorm3D", lambda nn, T: nn.InstanceNorm3D(4), (2, 4, 3, 3, 3)),
    ("LocalResponseNorm", lambda nn, T: nn.LocalResponseNorm(3),
     (2, 4, 6, 6)),
]
CASES += [Case(n, b, (_x(*s),)) for n, b, s in _NORMS]
# the reference's local_response_norm does not differentiate (its
# reduce_window has no reverse-mode rule in JAX): its output only
CASES[-1] = CASES[-1]._replace(grad=None)
_POOLS = [
    ("MaxPool1D", lambda nn, T: nn.MaxPool1D(2), (2, 3, 8)),
    ("MaxPool2D", lambda nn, T: nn.MaxPool2D(2), (2, 3, 8, 8)),
    ("MaxPool3D", lambda nn, T: nn.MaxPool3D(2), (2, 3, 4, 4, 4)),
    ("AvgPool1D", lambda nn, T: nn.AvgPool1D(2), (2, 3, 8)),
    ("AvgPool2D", lambda nn, T: nn.AvgPool2D(2), (2, 3, 8, 8)),
    ("AvgPool3D", lambda nn, T: nn.AvgPool3D(2), (2, 3, 4, 4, 4)),
    ("AdaptiveAvgPool1D", lambda nn, T: nn.AdaptiveAvgPool1D(2), (2, 3, 8)),
    ("AdaptiveAvgPool2D", lambda nn, T: nn.AdaptiveAvgPool2D(2),
     (2, 3, 8, 8)),
    ("AdaptiveAvgPool3D", lambda nn, T: nn.AdaptiveAvgPool3D(2),
     (2, 3, 4, 4, 4)),
    ("AdaptiveMaxPool1D", lambda nn, T: nn.AdaptiveMaxPool1D(2), (2, 3, 8)),
    ("AdaptiveMaxPool2D", lambda nn, T: nn.AdaptiveMaxPool2D(2),
     (2, 3, 8, 8)),
    ("AdaptiveMaxPool3D", lambda nn, T: nn.AdaptiveMaxPool3D(2),
     (2, 3, 4, 4, 4)),
    ("LPPool2D", lambda nn, T: nn.LPPool2D(2, 2), (2, 3, 8, 8)),
]
CASES += [Case(n, b, (_x(*s),)) for n, b, s in _POOLS]
_CONVS = [
    ("Conv1D", lambda nn, T: nn.Conv1D(3, 5, 3, padding=1), (2, 3, 8)),
    ("Conv2D", lambda nn, T: nn.Conv2D(3, 5, 3, padding=1), (2, 3, 8, 8)),
    ("Conv3D", lambda nn, T: nn.Conv3D(3, 5, 3, padding=1),
     (2, 3, 4, 4, 4)),
    ("Conv1DTranspose", lambda nn, T: nn.Conv1DTranspose(3, 5, 2, stride=2),
     (2, 3, 4)),
    ("Conv2DTranspose", lambda nn, T: nn.Conv2DTranspose(3, 5, 2, stride=2),
     (2, 3, 4, 4)),
    ("Conv3DTranspose", lambda nn, T: nn.Conv3DTranspose(3, 5, 2, stride=2),
     (2, 3, 2, 2, 2)),
]
# cuDNN's convolutions sum in another order than the CPU's (card_tol)
CASES += [Case(n, b, (_x(*s),), card_tol=1e-4) for n, b, s in _CONVS]
_PADS = [
    ("Pad1D", lambda nn, T: nn.Pad1D(1), (2, 3, 6)),
    ("Pad2D", lambda nn, T: nn.Pad2D(1), (2, 3, 6, 6)),
    ("Pad3D", lambda nn, T: nn.Pad3D(1), (2, 3, 4, 4, 4)),
    ("ZeroPad2D", lambda nn, T: nn.ZeroPad2D(1), (2, 3, 6, 6)),
]
CASES += [Case(n, b, (_x(*s),)) for n, b, s in _PADS]
CASES += [
    Case("PixelShuffle", lambda nn, T: nn.PixelShuffle(2), (_x(2, 8, 3, 3),)),
    Case("PixelUnshuffle", lambda nn, T: nn.PixelUnshuffle(2),
         (_x(2, 2, 6, 6),)),
    Case("ChannelShuffle", lambda nn, T: nn.ChannelShuffle(2),
         (_x(2, 4, 3, 3),)),
    Case("Flatten", lambda nn, T: nn.Flatten(), (_x(2, 3, 4),)),
    Case("Unflatten", lambda nn, T: nn.Unflatten(1, [3, 4]), (_x(2, 12),)),
    Case("Upsample", lambda nn, T: nn.Upsample(scale_factor=2),
         (_x(2, 3, 4, 4),)),
    Case("UpsamplingNearest2D",
         lambda nn, T: nn.UpsamplingNearest2D(scale_factor=2),
         (_x(2, 3, 4, 4),)),
    Case("UpsamplingBilinear2D",
         lambda nn, T: nn.UpsamplingBilinear2D(scale_factor=2),
         (_x(2, 3, 4, 4),)),
    Case("CosineSimilarity", lambda nn, T: nn.CosineSimilarity(),
         (_x(2, 6), X6), (0, 1)),
    Case("PairwiseDistance", lambda nn, T: nn.PairwiseDistance(),
         (_x(2, 6), X6), (0, 1)),
    Case("Bilinear", lambda nn, T: nn.Bilinear(3, 4, 5),
         (_x(2, 3), _x(2, 4)), (0, 1)),
]
CASES += [Case(f"{n}_eval", b, (_x(2, 3, 4, 4),), train=False)
          for n, b in (("Dropout", lambda nn, T: nn.Dropout(0.5)),
                       ("Dropout2D", lambda nn, T: nn.Dropout2D(0.5)),
                       ("AlphaDropout", lambda nn, T: nn.AlphaDropout(0.5)))]
_SEQ = _x(2, 5, 4)  # [b, t, in]
# cuDNN's recurrences on the card, in another order than the CPU's
CASES += [
    Case("SimpleRNN", lambda nn, T: nn.SimpleRNN(4, 6), (_SEQ,),
         card_tol=1e-4),
    Case("GRU", lambda nn, T: nn.GRU(4, 6), (_SEQ,), card_tol=1e-4),
    Case("LSTM", lambda nn, T: nn.LSTM(4, 6), (_SEQ,), card_tol=1e-4),
    Case("LSTM_bidirect", lambda nn, T: nn.LSTM(4, 6, direction="bidirect"),
         (_SEQ,), card_tol=1e-4),
]
# the Transformer specs in eval mode: the attention and residual dropout
# (0.1 by default) are held by statistics in test_torch_transformer.py
CASES += [
    Case("TransformerEncoderLayer",
         lambda nn, T: nn.TransformerEncoderLayer(8, 2, 16), (_x(2, 5, 8),),
         train=False),
    Case("TransformerEncoder", lambda nn, T: nn.TransformerEncoder(
        nn.TransformerEncoderLayer(8, 2, 16), 2), (_x(2, 5, 8),),
        train=False),
    Case("MultiHeadAttention", lambda nn, T: nn.MultiHeadAttention(8, 2),
         (_x(2, 5, 8), _x(2, 5, 8), _x(2, 5, 8)), (0, 1, 2), train=False),
    Case("Transformer", lambda nn, T: nn.Transformer(8, 2, 1, 1, 16),
         (_x(2, 5, 8), _x(2, 4, 8)), (0, 1), train=False),
]
IDS = np.array([[1, 2], [3, 0]], np.int64)
CASES += [
    Case("Embedding", lambda nn, T: nn.Embedding(10, 6), (IDS,), ()),
    Case("Unfold", lambda nn, T: nn.Unfold([2, 2]), (_x(2, 3, 4, 4),)),
    Case("Fold", lambda nn, T: nn.Fold([4, 4], [2, 2]), (_x(2, 12, 9),)),
]

# -- beyond the sweep ---------------------------------------------------------

_UNPOOL = [("MaxUnPool1D", (2, 3, 8), (2, 3, 4)),
           ("MaxUnPool2D", (2, 3, 4, 4), (2, 3, 2, 2)),
           ("MaxUnPool3D", (2, 2, 4, 4, 4), (2, 2, 2, 2, 2))]
CASES += [Case(n, lambda nn, T, n=n: getattr(nn, n)(2),
               (f32(*o), _pool_ids(i, o)), (0,)) for n, i, o in _UNPOOL]
CASES += [
    Case("Linear", lambda nn, T: nn.Linear(4, 3), (_x(2, 4),)),
    Case("Linear_no_bias", lambda nn, T: nn.Linear(4, 3, None, False),
         (_x(2, 4),)),
    Case("Embedding_padding_idx",
         lambda nn, T: nn.Embedding(10, 6, padding_idx=-10), (IDS,), ()),
    Case("Dropout3D_eval", lambda nn, T: nn.Dropout3D(0.5),
         (_x(2, 3, 2, 2, 2),), train=False),
    Case("BatchNorm2D_eval", lambda nn, T: nn.BatchNorm2D(4),
         (_x(2, 4, 6, 6),), train=False),
    Case("BatchNorm1D_nlc", lambda nn, T: nn.BatchNorm1D(
        4, data_format="NLC"), (_x(2, 8, 4),)),
    Case("SpectralNorm", lambda nn, T: nn.SpectralNorm([4, 3], 1, 2),
         (_x(4, 3),)),
    Case("LayerNorm_no_affine", lambda nn, T: nn.LayerNorm(
        [5, 8], weight_attr=False, bias_attr=False), (_x(2, 5, 8),)),
    Case("Conv2DTranspose_groups", lambda nn, T: nn.Conv2DTranspose(
        4, 6, 3, stride=2, padding=1, output_padding=1, groups=2),
        (_x(2, 4, 3, 3),), card_tol=1e-4),
    Case("Sequential", lambda nn, T: nn.Sequential(
        nn.Linear(4, 8), nn.ReLU(), nn.Identity(), nn.Linear(8, 2)),
        (_x(3, 4),)),
    Case("LayerList", lambda nn, T: nn.Sequential(*nn.LayerList(
        [nn.Linear(4, 4), nn.Tanh()])), (_x(3, 4),)),
    Case("LayerDict", lambda nn, T: nn.Sequential(*nn.LayerDict(
        {"fc": nn.Linear(4, 4), "act": nn.Sigmoid()}).values()),
        (_x(3, 4),)),
    Case("TransformerDecoder", lambda nn, T: nn.TransformerDecoder(
        nn.TransformerDecoderLayer(8, 2, 16, normalize_before=True), 2,
        nn.LayerNorm(8)), (_x(2, 4, 8), _x(2, 5, 8)), (0, 1), train=False),
]
# the loss layers, on the inputs of torch_functional_cases' loss rows
CASES += [
    Case("CrossEntropyLoss", lambda nn, T: nn.CrossEntropyLoss(
        weight=T(CW), label_smoothing=0.1), (LOGITS, LAB)),
    Case("MSELoss", lambda nn, T: nn.MSELoss(), (X, P), (0, 1)),
    Case("L1Loss", lambda nn, T: nn.L1Loss("sum"), (X, P), (0, 1)),
    Case("NLLLoss", lambda nn, T: nn.NLLLoss(T(CW)), (LOGITS, LAB)),
    Case("BCELoss", lambda nn, T: nn.BCELoss(), (P, T01)),
    Case("BCEWithLogitsLoss", lambda nn, T: nn.BCEWithLogitsLoss(
        pos_weight=T(PW)), (X * 3, T01)),
    Case("SmoothL1Loss", lambda nn, T: nn.SmoothL1Loss(delta=0.5),
         (X * 2, P), (0, 1)),
    Case("KLDivLoss", lambda nn, T: nn.KLDivLoss("batchmean"), (X, P)),
    Case("MarginRankingLoss", lambda nn, T: nn.MarginRankingLoss(0.2),
         (X, P, PM1), (0, 1)),
    Case("HingeEmbeddingLoss", lambda nn, T: nn.HingeEmbeddingLoss(0.5),
         (X, PM1)),
    Case("CosineEmbeddingLoss", lambda nn, T: nn.CosineEmbeddingLoss(0.1),
         (X, P, PM1[:, 0].copy()), (0, 1)),
    Case("TripletMarginLoss", lambda nn, T: nn.TripletMarginLoss(swap=True),
         (X, P, NEG), (0, 1, 2)),
    Case("MultiLabelSoftMarginLoss",
         lambda nn, T: nn.MultiLabelSoftMarginLoss(), (X * 2, T01)),
    Case("SoftMarginLoss", lambda nn, T: nn.SoftMarginLoss(), (X * 2, PM1)),
    # T steps of logaddexp, taken in another order on the card
    Case("CTCLoss", lambda nn, T: nn.CTCLoss(),
         (CTC_LP, CTC_LAB, CTC_IN, CTC_LEN), card_tol=1e-4),
    Case("PoissonNLLLoss", lambda nn, T: nn.PoissonNLLLoss(), (X, P * 3)),
    Case("GaussianNLLLoss", lambda nn, T: nn.GaussianNLLLoss(full=True),
         (X, P, P * 2), (0, 2)),
    Case("MultiMarginLoss", lambda nn, T: nn.MultiMarginLoss(
        2, 0.8, T(CW)), (LOGITS, LAB)),
    Case("TripletMarginWithDistanceLoss",
         lambda nn, T: nn.TripletMarginWithDistanceLoss(margin=0.5),
         (X, P, NEG), (0, 1, 2)),
    Case("RNNTLoss", lambda nn, T: nn.RNNTLoss(),
         (RNNT_X, RNNT_LAB, RNNT_IN, RNNT_LEN), card_tol=1e-4),
    Case("HSigmoidLoss", lambda nn, T: nn.HSigmoidLoss(5, 7),
         (HS_X, HS_LAB)),
]

# the random layers in training mode, held by statistics
RANDOM = ["Dropout", "Dropout2D", "Dropout3D", "AlphaDropout", "RReLU"]


def covered():
    """The ``nn`` names the cases build: each case's build function run
    against a namespace that records the attributes asked of it."""

    class _Names:
        def __init__(self):
            self.seen = set()

        def __getattr__(self, name):
            self.seen.add(name)
            return lambda *a, **k: _Stub()

    class _Stub:
        def __getattr__(self, name):
            return lambda *a, **k: _Stub()

        def __iter__(self):
            return iter(())

    names = _Names()
    for case in CASES:
        case.build(names, lambda a: a)
    return names.seen | set(RANDOM)



def _tensor(a, device):
    import torch

    return torch.from_numpy(np.array(a)).to(device)


def port_run(case, weights, device="cpu"):
    """The port's layer of ``case`` on ``device`` with the reference's
    ``weights`` (a ``state_dict`` of numpy arrays, loaded by name), called
    on the case's inputs: (float outputs, input gradients, parameter
    gradients by name, ``state_dict`` after the call), all numpy."""
    import torch

    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.framework.device import using_device

    with using_device(device):
        layer = case.build(tnn, lambda a: _tensor(a, device))
    tnn.layer.layers.load_jax_weights(layer, weights)
    layer.train(case.train)
    ts = [_tensor(a, device) for a in case.inputs]
    for i in case.grad or ():
        ts[i].requires_grad_(True)
    out = (case.call or (lambda m, *xs: m(*xs)))(layer, *ts)
    outs = [o for o in flat(out) if isinstance(o, torch.Tensor)
            and o.is_floating_point()]

    def host(t):
        return t.detach().float().cpu().numpy()

    state = {n: host(t) for n, t in layer.state_dict().items()}
    if case.grad is None:
        return [host(o) for o in outs], [], {}, state
    cots = cotangents([o.shape for o in outs])
    loss = sum((o * _tensor(c, device)).sum() for o, c in zip(outs, cots))
    named = [(n, p) for n, p in layer.named_parameters() if p.requires_grad]
    leaves = [ts[i] for i in case.grad] + [p for _, p in named]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True) \
        if leaves else []
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    k = len(case.grad)
    return ([host(o) for o in outs], [host(g) for g in grads[:k]],
            {n: host(g) for (n, _), g in zip(named, grads[k:])}, state)


def card_error(case):
    """The case on the card against the port's CPU result from the same
    weights (a CPU build's ``state_dict``): the largest error over
    outputs, input and parameter gradients and the state after the call,
    relative to each array's largest magnitude (or to 1). Raises on a
    shape that differs."""
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.framework.device import using_device

    with using_device("cpu"):
        layer = case.build(tnn, lambda a: _tensor(a, "cpu"))
    weights = {n: t.detach().numpy() for n, t in layer.state_dict().items()}
    want = port_run(case, weights, "cpu")
    got = port_run(case, weights, "cuda")
    pairs = list(zip(got[0], want[0])) + list(zip(got[1], want[1])) \
        + [(got[2][n], want[2][n]) for n in want[2]] \
        + [(got[3][n], want[3][n]) for n in want[3]]
    err = 0.0
    for g, w in pairs:
        if g.shape != w.shape:
            raise AssertionError(f"{case.id}: {g.shape} on the card, "
                                 f"{w.shape} on the CPU")
        err = max(err, float(np.abs(g - w).max(initial=0.0)) / max(
            float(np.abs(w).max(initial=0.0)), 1.0))
    return err
