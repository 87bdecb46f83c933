"""The port's vision layers held against the JAX package on the CPU.

The same numpy inputs (from a seed) go through each reference op and its
port; a fixed random cotangent gives every input's and weight's gradient
through each package's autograd. fp32 within 1e-5 relative (of the
output's largest magnitude): convolutions over every padding form of
Paddle (``'SAME'`` at stride 2 included), dilation, groups and both
layouts; the pools where torch's window rules part from the reference's
(``ceil_mode`` with a last window wholly in the padding, ``exclusive``)
and adaptive pools at ``in % out != 0``; ``batch_norm`` in train and
eval mode with the running statistics after 3 calls, and the O2 case
(bf16 input and scale, fp32 buffers) within 1e-2 in norm (the
reference rounds to bf16 after each of its five operations, the port
once, so single elements differ by a few bf16 steps). Then the layers'
``state_dict`` keys, ``set_state_dict``, the initializers' distributions
and the activations.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.nn import initializer as JI
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import initializer as TI

TOL = 1e-5


def _rng(seed=0):
    return np.random.RandomState(seed)


def _close(got, want, tol, name):
    """``got`` within ``tol`` of ``want``'s largest finite magnitude;
    the non-finite entries (-inf maxima, 0/0 averages) must match."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=name)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=name)
    if fin.any():
        scale = np.abs(want[fin]).max() + 1e-30
        np.testing.assert_allclose(got[fin] / scale, want[fin] / scale,
                                   atol=tol, rtol=0, err_msg=name)


def _close_norm(got, want, tol, name):
    """``|got - want| / |want|`` (2-norms) within ``tol``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < tol, (name, err)


def _both(jfn, tfn, arrays, tol=TOL, seed=1):
    """Forward and the gradient of ``sum(out * g)`` wrt every array, in
    both packages; returns the port's output."""
    jts = [pt.to_tensor(a, stop_gradient=False) for a in arrays]
    tts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    jo = jfn(*jts)
    to = tfn(*tts)
    want = jo.numpy()
    _close(to.detach().numpy(), want, tol, "forward")
    g = _rng(seed).randn(*want.shape).astype(np.float32)
    (jo * pt.to_tensor(g)).sum().backward()
    (to * torch.from_numpy(g)).sum().backward()
    for i, (jt, tt) in enumerate(zip(jts, tts)):
        _close(tt.grad.numpy(), jt.grad.numpy(), tol, f"grad {i}")
    return to


# -- convolutions -------------------------------------------------------------

CONV2D = [  # (padding, stride, dilation, groups)
    (1, 1, 1, 1),
    ([1, 2], 1, 1, 1),
    ([1, 0, 2, 1], 1, 1, 1),          # 2 * nd ints: (low, high) per dim
    ([[0, 2], [1, 0]], 2, 1, 1),      # nd pairs
    ("SAME", 2, 1, 1),                # XLA's SAME at stride 2
    ("SAME", 1, 2, 1),                # over the dilated window
    ("VALID", 2, 1, 2),
    (2, 1, 2, 2),
    (0, 3, 1, 4),
]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("padding,stride,dilation,groups", CONV2D)
def test_conv2d(padding, stride, dilation, groups, layout):
    r = _rng(3)
    x = r.randn(2, 4, 9, 8).astype(np.float32)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = (r.randn(8, 4 // groups, 3, 3) * 0.3).astype(np.float32)
    b = r.randn(8).astype(np.float32)
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, data_format=layout)
    out = _both(lambda x, w, b: JF.conv2d(x, w, b, **kw),
                lambda x, w, b: TF.conv2d(x, w, b, **kw), [x, w, b])
    if layout == "NHWC":  # a channels_last view in, a contiguous NHWC out
        assert out.is_contiguous()


@pytest.mark.parametrize("layout", ["NCL", "NLC"])
@pytest.mark.parametrize("padding,stride,dilation,groups",
                         [(1, 1, 1, 1), ([2, 1], 2, 1, 2), ("SAME", 2, 1, 1),
                          ("VALID", 1, 3, 1)])
def test_conv1d(padding, stride, dilation, groups, layout):
    r = _rng(4)
    x = r.randn(2, 4, 11).astype(np.float32)
    if layout == "NLC":
        x = np.ascontiguousarray(x.transpose(0, 2, 1))
    w = (r.randn(6, 4 // groups, 3) * 0.3).astype(np.float32)
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, data_format=layout)
    _both(lambda x, w: JF.conv1d(x, w, **kw),
          lambda x, w: TF.conv1d(x, w, **kw), [x, w])


@pytest.mark.parametrize("layout", ["NCDHW", "NDHWC"])
@pytest.mark.parametrize("padding,stride", [(1, 1), ("SAME", 2),
                                            ([0, 1, 1, 0, 2, 1], 1)])
def test_conv3d(padding, stride, layout):
    r = _rng(5)
    x = r.randn(1, 2, 5, 6, 7).astype(np.float32)
    if layout == "NDHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 4, 1))
    w = (r.randn(3, 2, 3, 3, 2) * 0.3).astype(np.float32)
    b = r.randn(3).astype(np.float32)
    kw = dict(stride=stride, padding=padding, data_format=layout)
    _both(lambda x, w, b: JF.conv3d(x, w, b, **kw),
          lambda x, w, b: TF.conv3d(x, w, b, **kw), [x, w, b])


def test_conv_nhwc_is_a_channels_last_view():
    """The permute at a conv's entry is a view in channels_last memory
    (no copy of the activation), and so is the one at its exit."""
    x = torch.randn(2, 9, 8, 4)
    v = x.movedim(-1, 1)
    assert v.is_contiguous(memory_format=torch.channels_last)
    assert v.data_ptr() == x.data_ptr()
    out = TF.conv2d(x, torch.randn(6, 4, 3, 3), padding=1,
                    data_format="NHWC")
    assert out.is_contiguous() and out.shape == (2, 9, 8, 6)


def test_conv_white_under_auto_cast():
    x = torch.randn(1, 2, 5, 5)
    w = torch.randn(3, 2, 3, 3)
    with amp.auto_cast(dtype="bfloat16"):
        out = TF.conv2d(x, w)
    assert out.dtype == torch.bfloat16


# -- pooling -----------------------------------------------------------------


def _pool_cases():
    # in 5, k 2, s 2, pad 1, ceil: the reference's last window lies wholly
    # in the padding (its max -inf, its exclusive average 0 / 0), torch's
    # ceil_mode drops it
    return [
        ("max", dict(kernel_size=3, stride=2, padding=1)),
        ("max", dict(kernel_size=2, stride=2, padding=1, ceil_mode=True)),
        ("max", dict(kernel_size=3, stride=2, padding="SAME")),
        ("max", dict(kernel_size=2, stride=1, padding=[0, 1])),
        ("avg", dict(kernel_size=2, stride=2, padding=1, ceil_mode=True,
                     exclusive=True)),
        ("avg", dict(kernel_size=2, stride=2, padding=1, ceil_mode=True,
                     exclusive=False)),
        ("avg", dict(kernel_size=3, stride=2, padding=1, exclusive=True)),
        ("avg", dict(kernel_size=3, stride=2, padding=1, exclusive=False)),
        ("avg", dict(kernel_size=3, stride=2, padding="SAME")),
        ("avg", dict(kernel_size=2, stride=3, padding=0, ceil_mode=True)),
    ]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kind,kw", _pool_cases())
def test_pool2d(kind, kw, layout):
    x = _rng(6).randn(2, 3, 5, 7).astype(np.float32)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    name = f"{kind}_pool2d"
    kw = dict(kw, data_format=layout)
    _both(lambda a: getattr(JF, name)(a, **kw),
          lambda a: getattr(TF, name)(a, **kw), [x])


def test_ceil_mode_parts_from_torch():
    """The case above where the shapes part: the reference's rule gives
    4 outputs a dim, torch's ceil_mode 3."""
    x = torch.randn(1, 1, 5, 5)
    assert torch.nn.functional.max_pool2d(
        x, 2, 2, 1, ceil_mode=True).shape[-1] == 3
    out = TF.max_pool2d(x, 2, 2, 1, ceil_mode=True)
    assert out.shape[-1] == 4 and torch.isinf(out[..., -1]).all()


@pytest.mark.parametrize("kind,kw", [
    ("max", dict(kernel_size=2, stride=2, padding=1, ceil_mode=True)),
    ("avg", dict(kernel_size=3, stride=2, padding=1, ceil_mode=True,
                 exclusive=True)),
    ("avg", dict(kernel_size=2, stride=2, exclusive=False))])
@pytest.mark.parametrize("nd", [1, 3])
def test_pool_1d_3d(kind, kw, nd):
    shape = (2, 3, 7) if nd == 1 else (1, 2, 5, 4, 7)
    x = _rng(7).randn(*shape).astype(np.float32)
    name = f"{kind}_pool{nd}d"
    _both(lambda a: getattr(JF, name)(a, **kw),
          lambda a: getattr(TF, name)(a, **kw), [x])


@pytest.mark.parametrize("name,shape,out,layout", [
    ("adaptive_avg_pool2d", (2, 3, 7, 5), (3, 2), "NCHW"),
    ("adaptive_avg_pool2d", (2, 7, 5, 3), (3, 2), "NHWC"),
    ("adaptive_avg_pool2d", (2, 3, 8, 8), 1, "NCHW"),
    ("adaptive_max_pool2d", (2, 3, 7, 5), (3, 2), None),
    ("adaptive_avg_pool1d", (2, 3, 7), 3, None),
    ("adaptive_avg_pool3d", (1, 2, 5, 6, 7), (2, 4, 3), "NCDHW"),
])
def test_adaptive_pools(name, shape, out, layout):
    x = _rng(8).randn(*shape).astype(np.float32)
    kw = {} if layout is None else {"data_format": layout}
    _both(lambda a: getattr(JF, name)(a, out, **kw),
          lambda a: getattr(TF, name)(a, out, **kw), [x])


def test_return_mask_raises():
    """``return_mask`` is ported: the function and the layer give the
    reference's pooled values and int32 indices; a channel-last layout
    raises, as in the reference."""
    x = _rng(9).randn(1, 2, 4, 6).astype(np.float32)
    want = JF.max_pool2d(pt.to_tensor(x), 2, return_mask=True)
    for got in (TF.max_pool2d(torch.from_numpy(x), 2, return_mask=True),
                tnn.MaxPool2D(2, return_mask=True)(torch.from_numpy(x))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w.numpy()))
        assert got[1].dtype == torch.int32
    with pytest.raises(ValueError, match="channel-first"):
        TF.max_pool2d(torch.zeros(1, 4, 4, 1), 2, return_mask=True,
                      data_format="NHWC")


# -- batch norm ---------------------------------------------------------------


@pytest.mark.parametrize("shape,layout", [
    ((4, 3, 5, 6), "NCHW"), ((4, 5, 6, 3), "NHWC"), ((8, 3), "NCHW"),
    ((4, 3, 7), "NCL"), ((2, 3, 3, 4, 5), "NCDHW")])
def test_batch_norm_train_and_running_stats(shape, layout):
    """Three train-mode calls (each its own batch): outputs and every
    gradient, then the running statistics; then eval mode on them."""
    c = shape[-1] if layout == "NHWC" else shape[1]
    r = _rng(9)
    w = (1 + 0.1 * r.randn(c)).astype(np.float32)
    b = (0.1 * r.randn(c)).astype(np.float32)
    jm = pt.to_tensor(np.zeros(c, np.float32))
    jv = pt.to_tensor(np.ones(c, np.float32))
    tm, tv = torch.zeros(c), torch.ones(c)
    for i in range(3):
        x = (2 * r.randn(*shape) + i).astype(np.float32)
        _both(lambda x, w, b: JF.batch_norm(x, jm, jv, w, b, training=True,
                                            data_format=layout),
              lambda x, w, b: TF.batch_norm(x, tm, tv, w, b, training=True,
                                            data_format=layout),
              [x, w, b], seed=i)
    _close(tm.numpy(), jm.numpy(), TOL, "running mean")
    _close(tv.numpy(), jv.numpy(), TOL, "running variance")
    x = r.randn(*shape).astype(np.float32)
    _both(lambda x, w, b: JF.batch_norm(x, jm, jv, w, b, training=False,
                                        data_format=layout),
          lambda x, w, b: TF.batch_norm(x, tm, tv, w, b, training=False,
                                        data_format=layout), [x, w, b])


@pytest.mark.parametrize("shape,layout", [
    ((1, 3), "NCHW"), ((1, 3, 1, 1), "NCHW"), ((1, 3), "NHWC"),
    ((1, 1, 1, 3), "NHWC")])
def test_batch_norm_one_value_per_channel(shape, layout):
    """Train mode with one value per channel, where torch's op refuses:
    the output is the shift, every gradient the reference's, and after 3
    calls the running mean and variance are the reference's (the
    variance shrinks by ``momentum`` a call)."""
    c = shape[-1] if layout == "NHWC" else shape[1]
    r = _rng(12)
    w = (1 + 0.1 * r.randn(c)).astype(np.float32)
    b = (0.1 * r.randn(c)).astype(np.float32)
    jm = pt.to_tensor(np.full(c, 0.5, np.float32))
    jv = pt.to_tensor(np.full(c, 2.0, np.float32))
    tm, tv = torch.full((c,), 0.5), torch.full((c,), 2.0)
    for i in range(3):
        x = (r.randn(*shape) + i).astype(np.float32)
        out = _both(lambda x, w, b: JF.batch_norm(
                        x, jm, jv, w, b, training=True, data_format=layout),
                    lambda x, w, b: TF.batch_norm(
                        x, tm, tv, w, b, training=True, data_format=layout),
                    [x, w, b], seed=i)
        np.testing.assert_allclose(out.detach().numpy().reshape(c), b,
                                   rtol=0, atol=1e-6)
    _close(tm.numpy(), jm.numpy(), TOL, "running mean")
    _close(tv.numpy(), jv.numpy(), TOL, "running variance")


def test_batch_norm_global_stats_in_training():
    """``use_global_stats=True`` normalizes by the running statistics and
    leaves them as they were, in train mode too."""
    x = _rng(10).randn(4, 3, 5, 5).astype(np.float32)
    tm, tv = torch.full((3,), 0.5), torch.full((3,), 2.0)
    jm, jv = (pt.to_tensor(np.full(3, v, np.float32)) for v in (0.5, 2.0))
    _both(lambda x: JF.batch_norm(x, jm, jv, training=True,
                                  use_global_stats=True),
          lambda x: TF.batch_norm(x, tm, tv, training=True,
                                  use_global_stats=True), [x])
    assert torch.equal(tm, torch.full((3,), 0.5))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batch_norm_o2_bf16(layout):
    """O2: bf16 input, scale and shift beside fp32 buffers (torch refuses
    a bf16 weight beside fp32 running buffers; the port casts the scale
    and shift to fp32). The output stays bf16; output and running
    statistics within 1e-2 (in norm) of the reference's bf16
    arithmetic."""
    r = _rng(11)
    shape = (8, 4, 6, 6) if layout == "NCHW" else (8, 6, 6, 4)
    x32 = (3 * r.randn(*shape) + 1).astype(np.float32)
    w32 = (1 + 0.1 * r.randn(4)).astype(np.float32)
    b32 = (0.1 * r.randn(4)).astype(np.float32)
    jx, jw, jb = (pt.to_tensor(a).astype("bfloat16") for a in (x32, w32, b32))
    tx, tw, tb = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in (x32, w32, b32))
    jm = pt.to_tensor(np.zeros(4, np.float32))
    jv = pt.to_tensor(np.ones(4, np.float32))
    tm, tv = torch.zeros(4), torch.ones(4)
    for _ in range(3):
        jo = JF.batch_norm(jx, jm, jv, jw, jb, training=True,
                           data_format=layout)
        to = TF.batch_norm(tx, tm, tv, tw, tb, training=True,
                           data_format=layout)
    assert to.dtype == torch.bfloat16 and tm.dtype == torch.float32
    _close_norm(to.float().numpy(),
                np.asarray(jo.astype("float32").numpy()), 1e-2, "output")
    _close_norm(tm.numpy(), jm.numpy(), 1e-2, "running mean")
    _close_norm(tv.numpy(), jv.numpy(), 1e-2, "running variance")


# -- layers -------------------------------------------------------------------


def test_state_dict_keys_equal_the_reference():
    """The same keys and shapes (torch lists a layer's buffers after its
    own parameters, the reference after every parameter of the tree)."""
    pairs = [
        (jnn.BatchNorm2D(4), tnn.BatchNorm2D(4, device="cpu")),
        (jnn.Conv2D(3, 4, 3), tnn.Conv2D(3, 4, 3, device="cpu")),
        (jnn.Conv2D(3, 4, 3, bias_attr=False),
         tnn.Conv2D(3, 4, 3, bias_attr=False, device="cpu")),
        (jnn.Sequential(jnn.Conv2D(3, 4, 1), jnn.BatchNorm2D(4), jnn.ReLU()),
         tnn.Sequential(tnn.Conv2D(3, 4, 1, device="cpu"),
                        tnn.BatchNorm2D(4, device="cpu"), tnn.ReLU())),
        (jnn.Sequential(("conv", jnn.Conv2D(3, 4, 1)),
                        ("bn", jnn.BatchNorm2D(4))),
         tnn.Sequential(("conv", tnn.Conv2D(3, 4, 1, device="cpu")),
                        ("bn", tnn.BatchNorm2D(4, device="cpu")))),
        (jnn.LayerList([jnn.BatchNorm2D(2), jnn.Conv1D(2, 2, 3)]),
         tnn.LayerList([tnn.BatchNorm2D(2, device="cpu"),
                        tnn.Conv1D(2, 2, 3, device="cpu")])),
    ]
    for jl, tl in pairs:
        assert sorted(jl.state_dict()) == sorted(tl.state_dict())
        for k, v in tl.state_dict().items():
            assert tuple(v.shape) == tuple(jl.state_dict()[k].shape), k
    bn = tnn.BatchNorm2D(4, device="cpu")
    assert bn._mean.dtype == bn._variance.dtype == torch.float32


def test_layers_match_the_reference_layers():
    """Conv2D, BatchNorm2D in train mode, the pools, Flatten and the
    activations as layers, with the reference's weights through
    ``set_state_dict`` (numpy arrays)."""
    pt.seed(0)
    jl = jnn.Sequential(jnn.Conv2D(3, 4, 3, padding=1), jnn.BatchNorm2D(4),
                        jnn.ReLU(), jnn.MaxPool2D(2, 2), jnn.Conv2D(4, 4, 1),
                        jnn.LeakyReLU(0.2), jnn.AvgPool2D(2, ceil_mode=True),
                        jnn.AdaptiveAvgPool2D(1), jnn.Flatten(),
                        jnn.Sigmoid())
    tl = tnn.Sequential(tnn.Conv2D(3, 4, 3, padding=1, device="cpu"),
                        tnn.BatchNorm2D(4, device="cpu"), tnn.ReLU(),
                        tnn.MaxPool2D(2, 2), tnn.Conv2D(4, 4, 1, device="cpu"),
                        tnn.LeakyReLU(0.2), tnn.AvgPool2D(2, ceil_mode=True),
                        tnn.AdaptiveAvgPool2D(1), tnn.Flatten(), tnn.Sigmoid())
    missing, unexpected = tl.set_state_dict(
        {k: np.asarray(v._data) for k, v in jl.state_dict().items()})
    assert missing == [] and unexpected == []
    x = _rng(12).randn(2, 3, 7, 7).astype(np.float32)
    _close(tl(torch.from_numpy(x)).detach().numpy(),
           jl(pt.to_tensor(x)).numpy(), TOL, "layers")
    _close(tl[1]._mean.numpy(), np.asarray(jl[1]._mean._data), TOL, "mean")


def test_set_state_dict_rebinds_and_checks():
    bn = tnn.BatchNorm2D(3, device="cpu")
    ptr = bn._mean.data_ptr()
    missing, unexpected = bn.set_state_dict(
        {"_mean": np.arange(3, dtype=np.float32), "extra": np.zeros(1)})
    assert missing == ["weight", "bias", "_variance"]
    assert unexpected == ["extra"]
    assert bn._mean.tolist() == [0.0, 1.0, 2.0]
    assert bn._mean.data_ptr() != ptr  # new storage, as the reference
    with pytest.raises(ValueError, match="shape mismatch"):
        bn.set_state_dict({"weight": np.ones(4, np.float32)})
    conv = tnn.Conv2D(2, 2, 1, device="cpu")
    conv(torch.randn(1, 2, 3, 3)).sum().backward()
    conv.clear_gradients()
    assert all(p.grad is None for p in conv.parameters())


def test_create_parameter_and_param_attr():
    class Net(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.w = self.create_parameter(
                [3, 4], attr=tnn.ParamAttr(initializer=TI.Constant(2.0),
                                           trainable=False), device="cpu")
            self.b = self.create_parameter([4], is_bias=True, device="cpu")
            self.none = self.create_parameter([4], attr=False, device="cpu")
            self.register_buffer("scratch", torch.zeros(2),
                                 persistable=False)

    net = Net()
    assert torch.equal(net.w, torch.full((3, 4), 2.0))
    assert not net.w.requires_grad and net.b.requires_grad
    assert torch.equal(net.b, torch.zeros(4)) and net.none is None
    assert list(net.state_dict()) == ["w", "b"]


def _draw_std(tensor_fn, init_fn):
    return float(np.std(tensor_fn(init_fn)))


@pytest.mark.parametrize("name,args", [
    ("Normal", (0.5, 2.0)), ("Uniform", (-0.3, 0.7)),
    ("XavierUniform", ()), ("XavierNormal", ()),
    ("KaimingUniform", ()), ("KaimingNormal", ()),
    ("KaimingUniform", (None, math.sqrt(5.0), "leaky_relu"))])
def test_initializer_distributions(name, args):
    """Parity of distribution: mean, std and range of 64 x 32 x 3 x 3
    draws against the reference's (the bits differ by design)."""
    shape = (64, 32, 3, 3)
    want = np.asarray(getattr(JI, name)(*args)(shape, "float32"))
    got = getattr(TI, name)(*args)(
        torch.empty(shape), torch.Generator().manual_seed(0)).numpy()
    assert abs(got.mean() - want.mean()) < 0.02 * max(want.std(), 1e-3) + 0.01
    assert abs(got.std() / want.std() - 1) < 0.02
    if "Uniform" in name:
        assert abs(np.abs(got).max() / np.abs(want).max() - 1) < 0.01


def test_initializer_constant_and_assign():
    t = torch.empty(2, 3)
    assert torch.equal(TI.Constant(1.5)(t), torch.full((2, 3), 1.5))
    vals = np.arange(6, dtype=np.float32)
    assert TI.Assign(vals)(t).flatten().tolist() == list(range(6))


@pytest.mark.parametrize("name,extra", [("relu", ()), ("relu6", ()),
                                        ("sigmoid", ()),
                                        ("leaky_relu", (0.2,))])
def test_activations(name, extra):
    x = (4 * _rng(13).randn(3, 17)).astype(np.float32)
    _both(lambda a: getattr(JF, name)(a, *extra),
          lambda a: getattr(TF, name)(a, *extra), [x])


def test_cross_entropy_loss_layer():
    r = _rng(14)
    logits = r.randn(6, 10).astype(np.float32)
    labels = r.randint(0, 10, (6, 1)).astype(np.int64)
    want = jnn.CrossEntropyLoss()(pt.to_tensor(logits),
                                  pt.to_tensor(labels)).numpy()
    got = tnn.CrossEntropyLoss()(torch.from_numpy(logits),
                                 torch.from_numpy(labels)).numpy()
    _close(got, want, TOL, "loss")
    soft = r.dirichlet(np.ones(10), 6).astype(np.float32)
    w = r.uniform(0.5, 2, 10).astype(np.float32)
    for kw, lab in ((dict(soft_label=True), soft),
                    (dict(label_smoothing=0.1), labels),
                    (dict(axis=0), labels.T.copy()),
                    (dict(weight=w), labels)):
        x = logits.T.copy() if kw.get("axis") == 0 else logits
        jkw = {k: pt.to_tensor(v) if k == "weight" else v
               for k, v in kw.items()}
        tkw = {k: torch.from_numpy(v) if k == "weight" else v
               for k, v in kw.items()}
        want = jnn.CrossEntropyLoss(**jkw)(pt.to_tensor(x),
                                           pt.to_tensor(lab)).numpy()
        got = tnn.CrossEntropyLoss(**tkw)(torch.from_numpy(x),
                                          torch.from_numpy(lab)).numpy()
        _close(got, want, TOL, str(kw))


def test_dropout_layer():
    d = tnn.Dropout(0.5)
    x = torch.ones(1000)
    y = d(x)
    assert set(y.unique().tolist()) <= {0.0, 2.0}
    d.eval()
    assert torch.equal(d(x), x)
    rows = tnn.Dropout(0.5, axis=1)(torch.ones(8, 1000))
    assert (rows == rows[:1]).all()